#!/usr/bin/env python3
"""Time one chunk of the device MSM and its tree kernel on one CUDA card.

    python3 tools/msm_chunk_ab.py [--repo DIR] [--rounds N]

Imports reef_tpu_torch from DIR (default: the checkout that holds this
script), so that one machine can time two checkouts of the port in turns
(A B B A) on the same card and host.  Builds the two kernels the chunk
runs (K1 csrc/padd.cu and K2 csrc/msm_tree.cu) into DIR's build directory.

The chunk is `ec/msm_v3.py` `chunk_prefixes` at cap 16384 on Pallas, all
32 windows, as the commit MSM runs it: sort, counts, gather, K2, the
Fenwick gather and K1 reduce.  Its glue is some forty torch launches, so
its time follows the host as well as the card; `host_launch_us`, the mean
wall time of one one-element torch add on the card, says how fast the
host issues launches.

Prints one JSON line: the card's name and power limit (nvidia-smi), the
chunk's ms a call for each round (CUDA events over 5 calls), the host's
wall ms to issue one (5 calls, no wait), K2's ms a call (`tree_levels`,
10 calls), the host probe, and a digest of the chunk's output, which
must agree between checkouts.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

CAP = 16384


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs after one warm run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("msm_chunk_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm_v3
    from reef_tpu_torch.ec.msm import pallas_kernels
    from reef_tpu_torch.utils import cudabuild

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cudabuild.build(["padd", "msm_tree"])
    build_s = time.perf_counter() - t0

    dev = torch.device("cuda")
    ck = pallas_kernels()
    cv = ck.curve
    gens = PedersenGens(cv, b"msm_chunk_ab", CAP).G
    basis = msm_v3.DeviceBasisV3(ck, gens, cap=CAP, device=dev)
    rng = np.random.default_rng(20261017)
    scb = torch.from_numpy(rng.integers(0, 256, (CAP, 32), dtype=np.uint8)
                           ).to(dev)
    acc = ck.ident_t(dev)[:, :, None, None].expand(
        3, 8, msm_v3.N_WINDOWS, msm_v3.DP).contiguous()

    def chunk():
        return msm_v3.chunk_prefixes(ck, basis.arr[0], scb, acc, True)

    digest = hashlib.sha256(chunk().cpu().numpy().tobytes()).hexdigest()[:16]
    chunk_ms = [cuda_ms(torch, chunk, reps=5) for _ in range(args.rounds)]
    # the host's own time to issue a chunk: 5 calls with no wait between
    # them (the launch queue holds all of them)
    enqueue_ms = []
    for _ in range(args.rounds):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            chunk()
        enqueue_ms.append((time.perf_counter() - t1) / 5 * 1e3)
        torch.cuda.synchronize()

    order = torch.stack([torch.randperm(CAP, generator=torch.Generator()
                                        .manual_seed(w)) for w in
                         range(msm_v3.N_WINDOWS)]).to(dev)
    placed = basis.arr[0][:2][:, :, order].contiguous()
    tree_ms = cuda_ms(torch, lambda: msm_v3.tree_levels(ck, placed),
                      reps=10)

    one = torch.zeros(1, device=dev)
    for _ in range(200):
        one.add_(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(2000):
        one.add_(1)
    torch.cuda.synchronize()
    host_launch_us = (time.perf_counter() - t1) / 2000 * 1e6

    print(json.dumps({"repo": repo, "card": smi, "cap": CAP,
                      "build_s": build_s, "chunk_ms": chunk_ms,
                      "enqueue_ms": enqueue_ms,
                      "tree_ms": tree_ms, "host_launch_us": host_launch_us,
                      "digest": digest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
