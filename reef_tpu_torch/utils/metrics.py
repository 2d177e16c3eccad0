"""Timer/counter registry + CSV export.

Mirrors the reference metrics crate (reference metrics/metrics.rs):
restartable wall-clock timers (`tic`/`stop`), constraint counts (`r1cs`),
byte sizes (`space`), flushed to CSV rows
[type, component, test, value, metric_type] (metrics.rs:135).
Components: Compiler, Prover, Solver, Verifier, CommitmentGen.
"""

from __future__ import annotations

import csv
import time
from typing import Dict, Tuple


class Metrics:
    def __init__(self):
        self.timers: Dict[Tuple[str, str], float] = {}
        self._running: Dict[Tuple[str, str], float] = {}
        self.counts: Dict[Tuple[str, str, str], int] = {}

    def tic(self, component: str, test: str):
        self._running[(component, test)] = time.time()

    def stop(self, component: str, test: str):
        key = (component, test)
        start = self._running.pop(key, None)
        if start is not None:
            self.timers[key] = self.timers.get(key, 0.0) + time.time() - start

    def r1cs(self, component: str, test: str, n: int):
        self.counts[("constraints", component, test)] = n

    def space(self, component: str, test: str, n_bytes: int):
        self.counts[("space", component, test)] = n_bytes

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
