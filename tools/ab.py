#!/usr/bin/env python3
"""Time a checkout of the port on one CUDA card, phase by phase.

    python3 tools/ab.py [--repo DIR] [--phases msm k5] [--rounds N]

Imports reef_tpu_torch from DIR (default: the checkout that holds this
script), so that one machine can time two checkouts of the port in turns
(A B B A) on the same card and host.  Builds the kernels each phase runs
into DIR's build directory.  Prints one JSON line a phase, each with the
card's name and power limit (nvidia-smi), the phase's build seconds and
digests of its outputs, which must agree between checkouts.

msm: one chunk of the device MSM, its kernels and K6's coefficient
rounds (K1 csrc/padd.cu, K2 csrc/msm_tree.cu, K6 csrc/sumcheck.cu).
The chunk is `ec/msm_v3.py` `chunk_prefixes` at cap 16384 on Pallas, all
32 windows, as the commit MSM runs it: sort, counts, gather, K2, the
Fenwick gather and K1 reduce.  Its glue is some forty torch launches, so
its time follows the host as well as the card; `host_launch_us`, the mean
wall time of one one-element torch add on the card, says how fast the
host issues launches.  The line holds the chunk's ms a call for each
round (CUDA events over 5 calls), the host's wall ms to issue one (5
calls, no wait), K2's ms a call (`tree_levels`, 10 calls) and the host
probe.  Then the device time (`device_ms`: the launches queued behind a
sleep on the card, so that the host's issue rate does not show) of the
MSM's two K1 reduces as the checkout runs them (the Fenwick levels of a
chunk with its acc add, and the digit halving: one `padd_reduce` launch
each where the checkout has it, else one K1 launch a level), of each
such level launch alone, and of K6's coefficient pass at every round of
a 2^20-entry sumcheck (half = 2^19 .. 1, with a t = 9 sponge state).

k5: K5's thread-per-state launch (csrc/poseidon.cu; K6 for the step),
the flagship step and the device Merkle build.  The line holds the ms a
launch of K5's THREAD launch (CUDA events) at (5, 8, 2^19) and
(9, 8, 2^19) on F_q and at (5, 8, 2^14), the batch of the reference's
permutations/s line (bench.py bench_poseidon); the flagship
`device_step` at B = half = 2^19; and the wall seconds of two
`build_tree_device` runs over the 1 MB DNA document (2^19 leaves).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
# this checkout's
from chip_smoke import cuda_ms, device_ms, dna_text, nvidia_smi  # noqa: E402

CAP = 16384
K5_BIG, K5_BENCH = 1 << 19, 1 << 14


def digest_of(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernel_times(torch, ck, basis, acc, dev) -> dict:
    """K1's two MSM reduces and K6's coefficient rounds (see the module
    docstring), by whichever launches the checkout has."""
    from reef_tpu_torch.ec import msm_v3
    from reef_tpu_torch.ec import padd as PD
    from reef_tpu_torch.models.prover_step import random_elems
    from reef_tpu_torch.ops import limb
    from reef_tpu_torch.ops import sumcheck_kernel as K

    W, DP, L = msm_v3.N_WINDOWS, msm_v3.DP, 16
    pts = basis.arr[0]                                     # (3, 8, CAP)
    idx = torch.arange(W * L * DP, device=dev) * 7 % CAP
    fen = pts[:, :, idx].reshape(3, 8, W, L, DP).contiguous()

    if hasattr(PD, "padd_reduce"):
        def fenwick():
            return PD.padd_reduce(ck, fen, acc)

        def digits():
            return PD.padd_reduce(ck, acc[..., None])[..., 0]

        # the plain reduce over padd_soa: one K1 launch a level
        def fenwick_levels():
            return PD.padd_reduce_plain(ck, fen, acc, PD.padd_soa)

        def digit_levels():
            return PD.padd_reduce_plain(ck, acc[..., None], None,
                                        PD.padd_soa)[..., 0]
    else:
        # a checkout before the reduce kernel: its own per-level launches
        def fenwick_levels():
            g, n = fen, L
            while n > 1:
                n //= 2
                g = msm_v3._padd_nd(ck, PD.padd_soa, g[..., :n, :],
                                    g[..., n:, :])
            return msm_v3._padd_nd(ck, PD.padd_soa, acc, g[..., 0, :])

        def digit_levels():
            return msm_v3.halve_digits(ck, acc)
        fenwick, digits = fenwick_levels, digit_levels
    out = {"fenwick_ms": device_ms(torch, fenwick),
           "digits_ms": device_ms(torch, digits),
           "k1_digest": digest_of([fenwick(), digits()]),
           "per_level_digest": digest_of([fenwick_levels(),
                                          digit_levels()])}
    # each per-level K1 launch of the MSM alone, by lanes
    lanes = sorted({W * DP * n for n in (8, 4, 2, 1)} |
                   {W * s for s in (128, 64, 32, 16, 8, 4, 2, 1)})
    flat = fen.reshape(3, 8, -1)
    out["padd_ms_by_lanes"] = {}
    for B in lanes:
        P, Q = flat[..., :B].contiguous(), flat[..., B:2 * B].contiguous()
        out["padd_ms_by_lanes"][str(B)] = device_ms(
            torch, lambda: PD.padd_soa(ck, P, Q))
    # K6: a 2^20-entry sumcheck's 20 coefficient rounds
    g = torch.Generator().manual_seed(20261017)
    lf = limb.FQ
    T = random_elems((1 << 20,), g, dev)
    E = random_elems((1 << 20,), g, dev)
    st = random_elems((9,), g, dev).T.reshape(9, 8, 1).contiguous()
    rounds, outs = [], []
    for lh in range(19, -1, -1):
        h = 1 << lh
        hv = (T[:, :h], T[:, h:2 * h], E[:, :h], E[:, h:2 * h])
        outs += list(K.coeffs(lf, *hv, st))
        rounds.append(device_ms(torch, lambda: K.coeffs(lf, *hv, st)))
    out.update(coeff_round_ms=rounds, coeff_sum_ms=sum(rounds),
               k6_digest=digest_of(outs))
    return out


def phase_msm(torch, dev, rounds: int) -> dict:
    """The chunk, K2, K1's reduces and K6's rounds; see the module
    docstring."""
    import numpy as np
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm_v3
    from reef_tpu_torch.ec.msm import pallas_kernels
    from reef_tpu_torch.utils import cudabuild

    t0 = time.perf_counter()
    cudabuild.build(["padd", "msm_tree", "sumcheck"])
    build_s = time.perf_counter() - t0

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
    chunk_ms = [cuda_ms(torch, chunk, reps=5) for _ in range(rounds)]
    # the host's own time to issue a chunk: 5 calls with no wait between
    # them (the launch queue holds all of them)
    enqueue_ms = []
    for _ in range(rounds):
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

    kernels = kernel_times(torch, ck, basis, chunk(), dev)
    return {"cap": CAP, "build_s": build_s, "chunk_ms": chunk_ms,
            "enqueue_ms": enqueue_ms, "tree_ms": tree_ms,
            "host_launch_us": host_launch_us, "digest": digest, **kernels}


def k5_states(torch, t: int, B: int, seed: int, dev):
    from reef_tpu_torch.models.prover_step import random_elems
    g = torch.Generator(device="cpu").manual_seed(seed)
    return random_elems((t, B), g, dev).permute(1, 0, 2).contiguous()


def phase_k5(torch, dev) -> dict:
    """K5 THREAD, the step and the Merkle build; see the module
    docstring."""
    from reef_tpu_torch.backend.merkle import build_tree_device
    from reef_tpu_torch.backend.table import doc_transform
    from reef_tpu_torch.models import prover_step as PS
    from reef_tpu_torch.ops import limb
    from reef_tpu_torch.ops import poseidon_kernel as PK
    from reef_tpu_torch.utils import cudabuild
    t0 = time.perf_counter()
    built = cudabuild.build(["poseidon", "sumcheck"])
    out = {"build_s": time.perf_counter() - t0,
           "ptxas": [ln.strip() for ln in
                     built["poseidon"]["log"].splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln]}
    lf = limb.FQ
    digests = []
    for t, B, reps in ((5, K5_BIG, 5), (9, K5_BIG, 3), (5, K5_BENCH, 20)):
        X = k5_states(torch, t, B, seed=t * 100 + B.bit_length(), dev=dev)
        digests.append(PK.launch(lf, X, PK.THREAD))
        out[f"thread_t{t}_b{B}_ms"] = cuda_ms(
            torch, lambda: PK.launch(lf, X, PK.THREAD), reps=reps)
    args = PS.example_args(K5_BIG, K5_BIG, seed=1, device=dev)
    digests.extend(PS.device_step(*args))
    out["step_ms"] = cuda_ms(torch, lambda: PS.device_step(*args), reps=5)
    ab = [ord(c) for c in "ACGT"]
    udoc = doc_transform(ab, [ord(c) for c in dna_text(1_000_000)])
    secs, roots = [], []
    for _ in range(2):
        t1 = time.perf_counter()
        roots.append(build_tree_device(udoc, dev))
        secs.append(time.perf_counter() - t1)
    out.update(merkle_build_s=secs, digest=digest_of(digests),
               merkle_root=hex(roots[0])[:18])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--phases", nargs="+", choices=("msm", "k5"),
                    default=["msm", "k5"])
    ap.add_argument("--rounds", type=int, default=3,
                    help="msm: chunk timings")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import torch
    if not torch.cuda.is_available():
        print("ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = nvidia_smi()
    for phase in args.phases:
        res = (phase_msm(torch, dev, args.rounds) if phase == "msm"
               else phase_k5(torch, dev))
        print(json.dumps({"repo": repo, "card": card, "phase": phase,
                          **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
