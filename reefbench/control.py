"""The control of the benchmark's correctness check: runs of a cell with
one guarantee broken, which the check has to call incorrect.

The configurations state that a commitment binds exactly the document
the benchmark made.  The control breaks that: the worker commits to, and
proves against, the benchmark's document with one byte of its filler
changed at a seeded position, while the check works the commitment out
from the benchmark's document.  Each seed is one run of the cell at its
own size and load, in this one process; each prints one JSON line.

    python3 reefbench/control.py --workload dna_1mb.fresh \
        --seeds 101 102 103 --seconds 10
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
MASK64 = (1 << 64) - 1


def mutate(fill: str, seed: int):
    """A document filter: one filler byte of each document changed to
    the next character of `fill`, at a position drawn from the seed and
    the cycle."""
    def doc_filter(cyc, doc: bytes) -> bytes:
        rng = np.random.default_rng([seed & MASK64, 7, cyc.index & MASK64])
        pos = int(rng.integers(0, len(doc) // 2))
        out = bytearray(doc)
        out[pos] = ord(fill[(fill.index(chr(out[pos])) + 1) % len(fill)])
        return bytes(out)
    return doc_filter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="reefbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, REPO]
    from harness import loop, manifest
    cell = manifest.cell(manifest.load_manifest(), args.workload)
    fill = manifest.config(cell["config"])["fill"]
    for seed in args.seeds:
        res = loop.run_cell(args.workload, seed, args.seconds, False,
                            doc_filter=mutate(fill, seed))
        checks, correct = loop.judge(res)
        print(json.dumps({
            "seed": seed, "attempted": len(res["done"]), "correct": correct,
            "checks": {k: v for k, (v, _) in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
