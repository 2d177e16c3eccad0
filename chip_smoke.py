#!/usr/bin/env python3
"""Drive reef_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each with its seconds; any mismatch raises, so the
script exits non-zero and prints no result:

  env     the card (nvidia-smi name and power limit), torch and CUDA
  build   nvcc builds of the kernels (one process per source, together)
          and the g++ builds of the shared host libraries
  padd    K1 (csrc/padd.cu) against its plain version at B = 2^16 random
          points on both curves, with the identity, P+P and P+(-P) lanes;
          exact
  tree    K2 (csrc/msm_tree.cu) against its plain version at cap = 16384,
          all 32 windows; exact on every node, spot-checked on affine
          points against the python curve
  msm     msm_device_v3 at n = 2^16 on Pallas and Vesta against the native
          host MSM, msm_device_v3_rows at R = 4, n = 4096; exact.  Times
          with CUDA events, and one chunk of the plain pipeline on the
          card (a check of the algorithm, no yardstick of speed)
  e2e     `cli dna --e2e` in-process with REEF_DEVICE_MSM=1 on the 1 MB
          document of the reference's dna.sh workload (seed 42); must
          prove and verify, and both kernels must have launched.  The
          device MSMs are timed; then the same run is timed again in the
          warm process, with REEF_DEVICE_MSM=0 (host MSMs) and =1

Then the kernel table as one JSON line, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.  Needs torch with
CUDA, nvcc (CUDA_HOME or /usr/local/cuda) and g++; imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_INT_OPS_PER_S = 67e12      # non-tensor 32-bit rate (fp32 table row)
MULS_PER_PADD, MULS_PER_AFFINE_ADD = 14, 10
# a Montgomery product (csrc/field.cuh): 8 CIOS rounds of two 8-limb
# multiply-add chains (lo and hi halves: 32 mads) plus one m = t0*n0
MADS_PER_MUL = 8 * (2 * 2 * 8 + 1)

DNA_MOTIF = "ATGGGCTACAGAAACCGTGCCAAA"
# the shapes of each phase (module constants, so a rehearsal on the CPU
# can shrink them)
PADD_LANES = 1 << 16
TREE_CAP = 16384
MSM_N = 1 << 16
ROWS, ROW_N = 4, 4096
DNA_BYTES = 1_000_000


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase,
                      "seconds": round(time.perf_counter() - t0, 3), **kw}),
          flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    for _ in range(warm):
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


def bound_ms(nbytes: int, mads: int):
    """Least time for the work: bytes over the memory rate, or the
    multiply-adds (2 operations each) over the 32-bit rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2 * mads / H100_INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def points_of(ck, gens, device, torch):
    """(n, 3, 8) projective host points -> (3, 8, n) int32 on device."""
    return torch.from_numpy(ck.to_proj(gens)).permute(1, 2, 0) \
        .contiguous().to(device)


def main() -> int:
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm_v3, native_msm
    from reef_tpu_torch.ec.msm import pallas_kernels, vesta_kernels
    from reef_tpu_torch.ec.padd import padd_soa, padd_soa_plain
    from reef_tpu_torch.utils import cudabuild, device, nativebuild

    dev = device.select("cuda")
    rnd = random.Random(20261017)
    kernels = {}

    # ---- env -------------------------------------------------------------
    t0 = time.perf_counter()
    smi = nvidia_smi()
    emit("env", t0, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        native = [ex.submit(nativebuild.build_native_lib,
                            nativebuild.native_src(src), stem, extra)
                  for src, stem, extra in (
                      ("msm.cpp", "libpastamsm", None),
                      ("fieldvec.cpp", "libfieldvec", None),
                      ("solver.cpp", "libsafasolver", ["-pthread"]))]
        built = cudabuild.build()
        for fut in native:
            fut.result()
    ptxas = {name: [ln.strip() for ln in b["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, b in built.items()}
    emit("build", t0, nvcc_seconds={k: round(v["seconds"], 3)
                                    for k, v in built.items()},
         ptxas=ptxas)
    for name in cudabuild.LIBS:
        cudabuild.library(name)

    curves = [pallas_kernels(), vesta_kernels()]

    # ---- padd (K1) -------------------------------------------------------
    t0 = time.perf_counter()
    B = PADD_LANES
    res = {}
    for ck in curves:
        cv = ck.curve
        gens = PedersenGens(cv, b"chip_smoke/padd", B).G
        A = points_of(ck, gens, dev, torch)
        perm = list(range(B))
        rnd.shuffle(perm)
        Bp = points_of(ck, [gens[i] for i in perm], dev, torch)
        # general projective inputs (Z != 1): sums of affine points
        P = padd_soa_plain(ck, A, Bp)
        Q = padd_soa_plain(ck, Bp, padd_soa_plain(ck, A, A))
        # special lanes: 0 + 0, 0 + Q, P + 0, P + P, P + (-P)
        ident = ck.ident_t(dev)
        P[:, :, 0] = ident
        Q[:, :, 0] = ident
        P[:, :, 1] = ident
        Q[:, :, 2] = ident
        Q[:, :, 3] = P[:, :, 3]
        Q[:, :, 4] = P[:, :, 4]
        y4 = ck.lf.decode32(P[1, :, 4:5])[0]
        Q[1, :, 4] = ck.lf.encode32([(-y4) % cv.p], dev)[:, 0]  # (X:-Y:Z)
        got = padd_soa(ck, P, Q)
        want = padd_soa_plain(ck, P, Q)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        require(err == 0, f"padd {cv.name}: kernel != plain (max {err})")
        aff = ck.to_affine(got[:, :, :8].permute(2, 0, 1))
        Pa = ck.to_affine(P[:, :, :8].permute(2, 0, 1))
        Qa = ck.to_affine(Q[:, :, :8].permute(2, 0, 1))
        require(aff == [cv.add(a, b) for a, b in zip(Pa, Qa)],
                f"padd {cv.name}: lanes 0..7 disagree with the curve")
        require(aff[0] is None and aff[4] is None,
                f"padd {cv.name}: 0 + 0 or P + (-P) is not the identity")
        ms = cuda_ms(torch, lambda: padd_soa(ck, P, Q), reps=20)
        plain_ms = cuda_ms(torch, lambda: padd_soa_plain(ck, P, Q), reps=2)
        res[cv.name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
    emit("padd", t0, lanes=B, **res)
    bms, by = bound_ms(B * 3 * 96, B * MULS_PER_PADD * MADS_PER_MUL)
    kernels["padd"] = {
        "name": "padd", "route": "cuda", "source":
            "reef_tpu_torch/csrc/padd.cu",
        "replaces": "reef_tpu/ec/pallas_ec.py:151",
        "max_abs_err": max(r["max_abs_err"] for r in res.values()),
        "ms": res["pallas"]["ms"], "plain_ms": res["pallas"]["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "shape": f"(3, 8, {B}) int32, Pallas"}

    # ---- tree (K2) -------------------------------------------------------
    t0 = time.perf_counter()
    cap, W = TREE_CAP, msm_v3.N_WINDOWS
    res = {}
    for ck in curves:
        cv = ck.curve
        gens = PedersenGens(cv, b"chip_smoke/tree", cap).G
        base = points_of(ck, gens, dev, torch)              # (3, 8, cap)
        g = torch.Generator(device="cpu").manual_seed(7)
        order = torch.stack([torch.randperm(cap, generator=g)
                             for _ in range(W)]).to(dev)    # (W, cap)
        placed = base[:2][:, :, order].contiguous()         # (2, 8, W, cap)
        got = msm_v3.tree_levels(ck, placed)
        want = msm_v3.tree_levels_plain(ck, placed)
        torch.cuda.synchronize()
        err = int((got[..., :cap - 1].long()
                   - want[..., :cap - 1].long()).abs().max())
        require(err == 0, f"tree {cv.name}: kernel != plain (max {err})")
        # affine spot checks: level-1 node 0 and the root of window 0 and W-1
        offs = msm_v3.level_offsets(cap)
        for w in (0, W - 1):
            idx = order[w].tolist()
            node = ck.to_affine(got[:, :, w, 0].cpu())
            require(node == cv.add(gens[idx[0]], gens[idx[1]]),
                    f"tree {cv.name}: level-1 node disagrees")
            root = ck.to_affine(got[:, :, w, offs[-1]].cpu())
            total = None
            for i in idx:
                total = cv.add(total, gens[i])
            require(root == total, f"tree {cv.name}: root disagrees")
        ms = cuda_ms(torch, lambda: msm_v3.tree_levels(ck, placed), reps=5)
        plain_ms = cuda_ms(torch, lambda: msm_v3.tree_levels_plain(
            ck, placed), reps=1)
        res[cv.name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
    emit("tree", t0, cap=cap, windows=W, **res)
    n_aff, n_full = W * cap // 2, W * (cap // 2 - 1)
    bms, by = bound_ms(W * cap * 2 * 32 + W * (cap - 1) * 96,
                       (n_aff * MULS_PER_AFFINE_ADD + n_full * MULS_PER_PADD)
                       * MADS_PER_MUL)
    kernels["msm_tree"] = {
        "name": "msm_tree", "route": "cuda",
        "source": "reef_tpu_torch/csrc/msm_tree.cu",
        "replaces": "reef_tpu/ec/msm_v3.py:182",
        "max_abs_err": max(r["max_abs_err"] for r in res.values()),
        "ms": res["pallas"]["ms"], "plain_ms": res["pallas"]["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "shape": f"(2, 8, {W}, {cap}) -> (3, 8, {W}, {cap}) int32, Pallas"}

    # ---- msm -------------------------------------------------------------
    t0 = time.perf_counter()
    n = MSM_N
    res = {}
    for ck in curves:
        cv = ck.curve
        gens = PedersenGens(cv, b"chip_smoke/msm", n)
        scalars = [rnd.randrange(cv.order) for _ in range(n)]
        basis = msm_v3.DeviceBasisV3(ck, gens.G, device=dev)
        got = msm_v3.msm_device_v3(ck, scalars, basis)
        want = native_msm.msm_packed(cv, scalars, gens.packed_G(),
                                     handle=gens.native_basis())
        require(got == want, f"msm {cv.name}: device != native host MSM")
        scb = msm_v3.upload_scalars(basis, [scalars])[0]
        ms = cuda_ms(torch, lambda: msm_v3.msm_windows(ck, basis, scb),
                     reps=3)
        t1 = time.perf_counter()
        msm_v3.msm_device_v3(ck, scalars, basis)
        call_s = time.perf_counter() - t1
        res[cv.name] = {"device_ms": ms, "pts_per_s": n / ms * 1e3,
                        "call_s": call_s}
    # one chunk of the plain pipeline on the card (no yardstick)
    ck = curves[0]
    acc = ck.ident_t(dev)[:, :, None, None].expand(
        3, 8, msm_v3.N_WINDOWS, msm_v3.DP).contiguous()
    gens = PedersenGens(ck.curve, b"chip_smoke/msm", n)
    basis_p = msm_v3.DeviceBasisV3(ck, gens.G, device=dev)
    scb_p = msm_v3.upload_scalars(
        basis_p, [[rnd.randrange(ck.curve.order) for _ in range(n)]])[0] \
        .reshape(basis_p.n_chunks, basis_p.cap, 32)
    plain_chunk_ms = cuda_ms(torch, lambda: msm_v3.chunk_prefixes(
        ck, basis_p.arr[0], scb_p[0], acc, True, padd_soa_plain,
        msm_v3.tree_levels_plain), reps=1)
    kernel_chunk_ms = cuda_ms(torch, lambda: msm_v3.chunk_prefixes(
        ck, basis_p.arr[0], scb_p[0], acc, True), reps=3)
    # rows: R = 4 over a 4096-point basis
    R, nr = ROWS, ROW_N
    gens = PedersenGens(ck.curve, b"chip_smoke/rows", nr)
    rows = [[rnd.randrange(ck.curve.order) for _ in range(nr)]
            for _ in range(R)]
    got = msm_v3.msm_device_v3_rows(ck, rows, msm_v3.DeviceBasisV3(
        ck, gens.G, device=dev))
    want = [native_msm.msm_packed(ck.curve, r, gens.packed_G(),
                                  handle=gens.native_basis()) for r in rows]
    require(got == want, "msm rows: device != native host MSM")
    emit("msm", t0, n=n, chunk=msm_v3.default_cap(), rows=R, row_n=nr,
         kernel_chunk_ms=kernel_chunk_ms,
         plain_chunk_ms_no_yardstick=plain_chunk_ms, **res)

    # ---- e2e: the main path ----------------------------------------------
    t0 = time.perf_counter()
    from reef_tpu_torch import cli
    msms = []
    orig = msm_v3.msm_device_v3

    def timed(ck, scalars, points):
        t1 = time.perf_counter()
        out = orig(ck, scalars, points)      # ends in a copy to the host
        msms.append((ck.curve.name, len(scalars), time.perf_counter() - t1))
        return out

    work = tempfile.mkdtemp(dir=nativebuild.build_dir())
    size = DNA_BYTES
    body = "".join(random.Random(42).choice("ACGT")
                   for _ in range(size - len(DNA_MOTIF)))
    doc = os.path.join(work, "dna.txt")
    with open(doc, "w") as fh:
        fh.write(body + DNA_MOTIF)
    argv = ["dna", "--e2e", "-d", doc, "-r",
            f"^.{{{size - len(DNA_MOTIF)}}}{DNA_MOTIF}.*", "-b", "0"]

    def e2e(route: str):
        """One commit + prove + verify with REEF_DEVICE_MSM=route, which
        must verify; returns its wall seconds."""
        prev_cwd, prev_env = os.getcwd(), os.environ.get("REEF_DEVICE_MSM")
        out = io.StringIO()
        try:
            os.environ["REEF_DEVICE_MSM"] = route
            os.chdir(work)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            os.chdir(prev_cwd)
            if prev_env is None:
                os.environ.pop("REEF_DEVICE_MSM", None)
            else:
                os.environ["REEF_DEVICE_MSM"] = prev_env
        require("Verification PASSED" in out.getvalue(),
                f"e2e ({route}): proof did not verify:\n" + out.getvalue())
        return wall

    try:
        msm_v3.msm_device_v3 = timed
        cudabuild.reset_counts()
        wall = e2e("1")
        launches = cudabuild.launch_counts()
        msm_v3.msm_device_v3 = orig
        # the same run again, warm (generators, circuits and bases cached
        # in the process): host MSMs, then device MSMs
        host_wall = e2e("0")
        warm_wall = e2e("1")
    finally:
        msm_v3.msm_device_v3 = orig
        shutil.rmtree(work, ignore_errors=True)
    require(all(v > 0 for v in launches.values()),
            f"e2e: a kernel of the main path never launched: {launches}")
    emit("e2e", t0, doc_bytes=size, wall_s=wall, device_msms=len(msms),
         device_msm_sizes=[m[:2] for m in msms],
         device_msm_s=sum(m[2] for m in msms), launches=launches,
         warm_wall_s=warm_wall, warm_host_msm_wall_s=host_wall)

    for name, k in kernels.items():
        k["launches"] = launches[name]
    table = [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")}
        for k in kernels.values()]
    print(json.dumps({"total_seconds": round(time.perf_counter() - t_all,
                                             3)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
