#!/usr/bin/env python3
"""Time the IPA prover's two round engines alone on one CUDA card.

    python3 tools/ipa_sweep.py [--logs 10 11 12 13 14 15 16] [--reps 3]

For each curve and each n = 2^log: a whole `backend/ipa.py` `ipa_prove`
of a random vector over the `reef/g/pv` basis of n points (the basis the
compressed SNARK opens over), warm: the generators, their device basis
and the kernels are made first, and each engine proves once untimed.
Then the native host engine (the policy `routes.ALL_HOST`) and the device
engine (`ec/ipa_device.py`, the policy's ipa floor lowered to 2) in
turns, host first in odd repetitions and device first in even ones,
`--reps` times each, the blinds seeded alike so that the two proofs must
be equal (and verify).  Prints one JSON line a size: the medians of each
engine's seconds a proof, the device engine's mean milliseconds a round
for `cross` and `fold`, and the card's name and power limit; the
crossover sets the ipa floor of backend/routes.py.

Each kernel of csrc/ipa.cu alone, against its plain version, with its
time and least time, is chip_smoke.py's phase `ipa`.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import secrets
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def prove(CM, ipa, gens, inputs, seed: int):
    """(seconds, proof) of one ipa_prove with blinds from `seed`."""
    G_s, w, rho, R, v, r_v, C_w, C_v = inputs
    blinds = random.Random(seed)
    orig = secrets.randbelow
    secrets.randbelow = lambda m: blinds.randrange(m)
    try:
        t0 = time.perf_counter()
        proof = ipa.ipa_prove(gens, G_s, w, rho, R, v, r_v, C_w, C_v,
                              CM.Transcript(b"sweep"))
        return time.perf_counter() - t0, proof
    finally:
        secrets.randbelow = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--logs", type=int, nargs="+",
                    default=list(range(10, 17)))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ipa_sweep: no CUDA device")
    from reef_tpu_torch.backend import commitment as CM
    from reef_tpu_torch.backend import ipa, routes
    from reef_tpu_torch.ec import ipa_device
    from reef_tpu_torch.ec.pasta import PALLAS, VESTA
    from reef_tpu_torch.utils import cudabuild
    cudabuild.library("ipa")
    engines = {"host": routes.ALL_HOST, "device": routes.Policy(ipa=2)}
    name = card()
    # the device engine's cross and fold, timed to the end of their work
    phase = {"cross": [], "fold": []}
    for meth in phase:
        def timed(self, *a, _f=getattr(ipa_device.IpaDevice, meth),
                  _k=meth):
            t0 = time.perf_counter()
            out = _f(self, *a)
            for s in self.streams:
                s.synchronize()
            phase[_k].append(time.perf_counter() - t0)
            return out
        setattr(ipa_device.IpaDevice, meth, timed)
    for cv in (PALLAS, VESTA):
        for log in args.logs:
            n = 1 << log
            rng = random.Random(log)
            p = cv.order
            gens = CM.PedersenGens(cv, b"reef/g/pv", n)
            gens.device_G()
            torch.cuda.synchronize()
            G_s = CM.shared_scalar_gens(cv).G[0]
            w = [rng.randrange(p) for _ in range(n)]
            R = [rng.randrange(p) for _ in range(n)]
            rho, r_v = rng.randrange(p), rng.randrange(p)
            v = sum(a * b for a, b in zip(w, R)) % p
            with routes.use(routes.ALL_HOST):
                C_w = gens.commit(w, rho)
            C_v = cv.add(cv.mul(v, G_s), cv.mul(r_v, gens.H))
            inputs = (G_s, w, rho, R, v, r_v, C_w, C_v)
            secs = {"host": [], "device": []}
            proofs = {}
            for rep in range(args.reps + 1):
                if rep == 1:
                    phase["cross"].clear()
                    phase["fold"].clear()
                order = ("host", "device") if rep % 2 else ("device", "host")
                for eng in order:
                    with routes.use(engines[eng]):
                        s, proofs[eng] = prove(CM, ipa, gens, inputs, rep)
                    if rep:                      # rep 0 warms up
                        secs[eng].append(s)
                if proofs["host"] != proofs["device"]:
                    raise SystemExit(f"ipa_sweep: the engines' proofs "
                                     f"differ at {cv.name} 2^{log}")
            with routes.use(routes.ALL_HOST):
                ok = ipa.ipa_verify(gens, G_s, R, C_w, C_v, proofs["device"],
                                    CM.Transcript(b"sweep"))
            if not ok:
                raise SystemExit(f"ipa_sweep: no verify at {cv.name} "
                                 f"2^{log}")
            print(json.dumps({
                "curve": cv.name, "log_n": log,
                "host_s": statistics.median(secs["host"]),
                "device_s": statistics.median(secs["device"]),
                "host_runs": secs["host"], "device_runs": secs["device"],
                "device_cross_ms": 1e3 * statistics.mean(phase["cross"]),
                "device_fold_ms": 1e3 * statistics.mean(phase["fold"]),
                "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
