"""The traced run's instruments, all from the benchmark's side of the
port's entry points: spans around layer entry points, the device routes
timed to a synchronise, every kernel launch's arguments, the port's
`--metrics` stage timers per request, and torch.profiler's device
activity over the window.
"""

from __future__ import annotations

import contextlib
import csv
import re
import time
from typing import Dict, List, Tuple

from . import peaks

# (module, attribute, span name): layer entry points wrapped in a span
SPANS = (
    ("reef_tpu_torch.cli", "build_safa", "frontend"),
    ("reef_tpu_torch.backend.framework", "pub_setup", "pub_setup"),
    ("reef_tpu_torch.backend.framework", "run_committer", "committer"),
    ("reef_tpu_torch.backend.framework", "run_prover", "prover"),
    ("reef_tpu_torch.backend.framework", "run_verifier", "verifier"),
)
# (module, attribute, route): the device routes' entry points, each timed
# from a synchronise to a synchronise; a route inside a route counts once
ROUTES = (
    ("reef_tpu_torch.backend.commitment", "PedersenGens._msm_device_route",
     "msm"),
    ("reef_tpu_torch.ec.msm_v3", "msm_device_v3_rows", "msm"),
    ("reef_tpu_torch.ops.sumcheck_device", "device_sumcheck_rounds",
     "sumcheck"),
)
SHORT_GAP_S = 1e-4
KERNEL_FN = re.compile(r"([A-Za-z_]\w*)\s*[<(]")


def _resolve(module: str, attr: str):
    import importlib
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, name


def read_stages(path: str) -> Dict[tuple, float]:
    """The `--metrics` CSV's timers, in seconds, under (component, name),
    and its counters' events under ("count", component, name)."""
    out: Dict[tuple, float] = {}
    with open(path, newline="") as fh:
        for row in csv.reader(fh):
            if len(row) != 5:
                continue
            if row[0] == "time":
                key, value = (row[1], row[2]), int(row[3]) / 1e6
            elif row[0] == "count":
                key, value = ("count", row[1], row[2]), int(row[3])
            else:
                continue
            out[key] = out.get(key, 0) + value
    return out


class Tracer:
    def __init__(self, torch):
        self.torch = torch
        self.role = "setup"
        self.spans: List[Tuple[str, float, float, int]] = []
        self.routes: Dict[str, float] = {}
        self.launches: List[Tuple[str, str, tuple]] = []
        self.recording = False
        self._depth = 0
        self._in_route = 0
        self._undo: List[Tuple[object, str, object]] = []
        self.prof = None
        self.t0 = self.t1 = 0.0

    # ---- wrappers --------------------------------------------------------

    def _patch(self, owner, name, wrapper) -> None:
        self._undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, wrapper)

    def install(self) -> None:
        from reef_tpu_torch.utils import cudabuild
        for module, attr, span in SPANS:
            owner, name = _resolve(module, attr)
            self._patch(owner, name, self._spanned(getattr(owner, name),
                                                   span))
        for module, attr, route in ROUTES:
            owner, name = _resolve(module, attr)
            self._patch(owner, name, self._timed(getattr(owner, name),
                                                 route))
        self._patch(cudabuild, "launch", self._recorded(cudabuild.launch))

    def uninstall(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)

    def _spanned(self, fn, span):
        tracer = self

        def wrapper(*a, **k):
            t0 = time.perf_counter()
            tracer._depth += 1
            depth = tracer._depth
            try:
                return fn(*a, **k)
            finally:
                tracer._depth -= 1
                tracer.spans.append((f"{tracer.role}/{span}", t0,
                                     time.perf_counter(), depth))
        return wrapper

    def _timed(self, fn, route):
        tracer, torch = self, self.torch

        def wrapper(*a, **k):
            if tracer._in_route:
                return fn(*a, **k)
            tracer._in_route += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tracer._in_route -= 1
                tracer.routes[route] = tracer.routes.get(route, 0.0) \
                    + t1 - t0
                tracer.spans.append((f"{tracer.role}/route.{route}", t0, t1,
                                     tracer._depth + 1))
        return wrapper

    def _recorded(self, fn):
        tracer = self

        def wrapper(name, kernel_fn, device, *args):
            if tracer.recording:
                tracer.launches.append((name, kernel_fn, args))
            return fn(name, kernel_fn, device, *args)
        return wrapper

    # ---- a request -------------------------------------------------------

    @contextlib.contextmanager
    def request(self, role: str):
        """Spans inside are the request's, labelled by its role; the
        routes' seconds start again from nothing."""
        self.role, self.routes = role, {}
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((role, t0, time.perf_counter(), 0))
            self.role = "between requests"

    # ---- the window ------------------------------------------------------

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.recording = True
        self.spans = []

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.recording = False
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def device_events(self):
        """(device index, name, start s, end s) of every device activity
        in the window, times from the window's start."""
        cuda = self.torch.autograd.DeviceType.CUDA
        out = []
        for ev in self.prof.events():
            if ev.device_type != cuda:
                continue
            out.append((ev.device_index, ev.name, ev.time_range.start / 1e6,
                        ev.time_range.end / 1e6))
        return out

    def segments(self) -> List[Tuple[float, float, str]]:
        """The window cut where any span starts or ends, each piece
        labelled with the innermost span the host was in (window times;
        "between requests" outside them)."""
        spans = [(a - self.t0, b - self.t0, name, d)
                 for name, a, b, d in self.spans]
        cuts = sorted({0.0, self.t1 - self.t0}
                      | {x for a, b, _, _ in spans for x in (a, b)})
        out = []
        for a, b in zip(cuts, cuts[1:]):
            mid, best, depth = (a + b) / 2, "between requests", -1
            for sa, sb, name, d in spans:
                if sa <= mid <= sb and d > depth:
                    best, depth = name, d
            out.append((a, b, best))
        return out


def busy_intervals(events, device: int) -> List[Tuple[float, float]]:
    iv = sorted((a, b) for d, _, a, b in events if d == device)
    out: List[List[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_by_span(idle, segments) -> Dict[str, float]:
    """Idle seconds by the span the host was in: gaps under 0.1 ms
    together, the longer ones cut at the segments' edges."""
    out: Dict[str, float] = {}
    short = "between launches (under 0.1 ms)"
    j = 0
    for a, b in idle:
        if b - a < SHORT_GAP_S:
            out[short] = out.get(short, 0.0) + (b - a)
            continue
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            sa, sb, lab = segments[k]
            part = min(b, sb) - max(a, sa)
            if part > 0:
                out[lab] = out.get(lab, 0.0) + part
            k += 1
    return out


def summarize(tracer: Tracer, devices: List[int], counts: dict,
              sm_count: int, sm_clock_mhz: float) -> dict:
    """busy_s, window_s, the kernel roofline share and the breakdown."""
    events = tracer.device_events()
    window = tracer.t1 - tracer.t0
    segments = tracer.segments()
    busy, gaps = [], {}
    for d in devices:
        iv = busy_intervals(events, d)
        busy.append(sum(b - a for a, b in iv))
        edges = [0.0] + [x for ab in iv for x in ab] + [window]
        idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        for lab, secs in idle_by_span(idle, segments).items():
            gaps[lab] = gaps.get(lab, 0.0) + secs / len(devices)
    by_op: Dict[str, float] = {}
    by_fn: Dict[str, float] = {}
    for _, name, a, b in events:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
        m = KERNEL_FN.search(name)
        fn = m.group(1) if m else name
        by_fn[fn] = by_fn.get(fn, 0.0) + (b - a)
    rate = peaks.imads_per_s(sm_count, sm_clock_mhz)
    bound_s = 0.0
    for lib, kernel_fn, args in tracer.launches:
        if lib in counts:
            imads, nbytes = counts[lib].work(kernel_fn, args)
            bound_s += max(imads / rate, nbytes / peaks.HBM_BYTES_PER_S)
    ours = {fn for mod in counts.values() for fn in mod.KERNELS}
    measured_s = sum(s for fn, s in by_fn.items() if fn in ours)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(busy) / len(busy), "window_s": window,
        "roofline_pct": (100.0 * bound_s / measured_s
                         if measured_s > 0 and bound_s > 0 else None),
        "kernel_s": by_fn, "bound_s": bound_s, "measured_s": measured_s,
        "breakdown": {"device_ops": [[k, v] for k, v in top],
                      "idle_gaps": [[k, v] for k, v in idle]},
    }
