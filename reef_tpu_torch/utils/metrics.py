"""Timer/counter registry, spans, and CSV export.

Mirrors the reference metrics crate (reference metrics/metrics.rs):
restartable wall-clock timers (`tic`/`stop`), constraint counts (`r1cs`),
byte sizes (`space`), flushed to CSV rows
[type, component, test, value, metric_type] (metrics.rs:135).
Components: Compiler, Prover, Solver, Verifier, CommitmentGen, MSM, Host,
and for the counters of the IPA round engines IPA (`device`, `mesh`,
`host`) and for the sharded calls of parallel/mesh.py Mesh (spans
`scalars`, `issue`, `gather`; counters `shards`, `gather_bytes`).
Compiler's span `restamp` and counter `circuit_restamp` mark a circuit
cache hit under another document commitment hash (backend/framework.py
`pub_setup`), beside its counters `circuit_cache_hit`/`_miss`.

Beyond the reference: spans and event counters recorded where the work
happens.  `span(component, name)` and `count(component, name, n)` are
module-level, so deep code needs no `Metrics` handed down to it; they
record into the `Metrics` that `recording` makes current (the CLI does so
for a request run with `--metrics FILE`) and do nothing otherwise.  A
span's duration adds into `timers`, so it leaves a `time` row under its
(component, name); a counter leaves a row
["count", component, name, n, "events"].  Every span, and every
`tic`/`stop` timer, is also kept as (component, name, thread ident,
t0_ns, t1_ns) on the `time.perf_counter_ns()` clock; `last_spans()`
returns the list of the last request that recorded.  Spans in helper
threads are recorded on their own thread, so the sum of one name's spans
can exceed the wall time of the stage that holds them.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import threading
import time
from typing import Dict, List, Optional, Tuple

Span = Tuple[str, str, int, int, int]

_CURRENT: Optional["Metrics"] = None
_LAST: List[Span] = []
_OFF = contextlib.nullcontext()
_GC, _GC_N = ("Host", "gc"), ("Host", "gc_collections")


class _Timed:
    """One span: records into `mt` on exit (the context manager that
    `span` returns while a request records)."""

    __slots__ = ("mt", "component", "name", "t0")

    def __init__(self, mt: "Metrics", component: str, name: str):
        self.mt, self.component, self.name = mt, component, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.mt._record(self.component, self.name, self.t0,
                        time.perf_counter_ns())
        return False


class Metrics:
    def __init__(self):
        self.timers: Dict[Tuple[str, str], float] = {}
        self._running: Dict[Tuple[str, str], int] = {}
        self.counts: Dict[Tuple[str, str, str], int] = {}
        self.events: Dict[Tuple[str, str], int] = {}
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._gc_t0 = 0

    def tic(self, component: str, test: str):
        self._running[(component, test)] = time.perf_counter_ns()

    def stop(self, component: str, test: str):
        start = self._running.pop((component, test), None)
        if start is not None:
            self._record(component, test, start, time.perf_counter_ns())

    def count(self, component: str, name: str, n: int = 1):
        key = (component, name)
        with self._lock:
            self.events[key] = self.events.get(key, 0) + n

    def _record(self, component: str, name: str, t0: int, t1: int):
        key = (component, name)
        with self._lock:
            self.timers[key] = self.timers.get(key, 0.0) + (t1 - t0) / 1e9
            self.spans.append((component, name, threading.get_ident(), t0,
                               t1))

    def r1cs(self, component: str, test: str, n: int):
        self.counts[("constraints", component, test)] = n

    def space(self, component: str, test: str, n_bytes: int):
        self.counts[("space", component, test)] = n_bytes

    def _on_gc(self, phase: str, info: dict):
        """`gc.callbacks` hook: each collection is a `Host gc` span on
        the thread that triggered it, and one `Host gc_collections`.  It
        takes no lock (a collection can start inside `_record`, on the
        thread that holds it): only collections write these two keys, and
        collections never overlap."""
        now = time.perf_counter_ns()
        if phase == "start":
            self._gc_t0 = now
        elif self._gc_t0:
            t0, self._gc_t0 = self._gc_t0, 0
            self.timers[_GC] = self.timers.get(_GC, 0.0) + (now - t0) / 1e9
            self.events[_GC_N] = self.events.get(_GC_N, 0) + 1
            self.spans.append(("Host", "gc", threading.get_ident(), t0, now))

    def write_csv(self, path: str, extra_rows=()):
        with open(path, "a", newline="") as fh:
            w = csv.writer(fh)
            for row in extra_rows:
                w.writerow(row)
            for (comp, test), secs in sorted(self.timers.items()):
                w.writerow(["time", comp, test, int(secs * 1e6), "μs"])
            for (kind, comp, test), val in sorted(self.counts.items()):
                unit = "constraints" if kind == "constraints" else "bytes"
                w.writerow([kind, comp, test, val, unit])
            for (comp, name), n in sorted(self.events.items()):
                w.writerow(["count", comp, name, n, "events"])


@contextlib.contextmanager
def recording(mt: Metrics):
    """Make `mt` current for the length of one request: the module-level
    spans and counters record into it, and so does a `gc.callbacks` hook
    (`Host gc` starts at zero, so a request without a collection reads
    0).  Afterwards `last_spans()` returns its spans."""
    global _CURRENT, _LAST
    mt.timers.setdefault(_GC, 0.0)
    mt.events.setdefault(_GC_N, 0)
    prev, _CURRENT = _CURRENT, mt
    gc.callbacks.append(mt._on_gc)
    try:
        yield mt
    finally:
        gc.callbacks.remove(mt._on_gc)
        _CURRENT = prev
        _LAST = mt.spans


def span(component: str, name: str):
    """A span of the current request; one shared no-op context when none
    is current."""
    mt = _CURRENT
    if mt is None:
        return _OFF
    return _Timed(mt, component, name)


def count(component: str, name: str, n: int = 1):
    """Add `n` to a counter of the current request, if one is current."""
    mt = _CURRENT
    if mt is not None:
        mt.count(component, name, n)


def last_spans() -> List[Span]:
    """The spans of the last request that recorded (one slot, replaced by
    each such request)."""
    return _LAST
