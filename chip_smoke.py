#!/usr/bin/env python3
"""Drive reef_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each with its seconds; any mismatch raises, so the
script exits non-zero and prints no result:

  env     the card (nvidia-smi name and power limit), torch and CUDA
  build   nvcc builds of the kernels (one process per source, together)
          and the g++ builds of the shared host libraries
  padd    K1 (csrc/padd.cu) against its plain version on both curves,
          with the identity, P+P and P+(-P) lanes: both launches of the add
          (a thread a lane, a group of six threads a lane) at B = 1, 2,
          37, the crossover -1, 0, +1, 8192 and 2^16, and the halving
          reduce against the per-level loop at the MSM's two shapes (the
          Fenwick levels with the acc add, the digits); also at the
          shapes the mesh adds (`mesh_path_shapes`: a Vesta shard's
          per-level adds, 32 .. 2^15 points on eight shards, the
          cross-shard reduce of the window sums, the step's point sums);
          exact.  The sweep
          of both add launches' device times over B = 2^0..2^16 that set
          the crossover (padd.THREAD_MIN_B), and the reduces against the
          per-level launches they replace
  tree    K2 (csrc/msm_tree.cu) against its plain version at cap = 4096
          and 16384 on both curves and 65536 on Pallas, and at a mesh
          shard's cap (8192 on Pallas on eight shards), all 32 windows;
          exact on every node, spot-checked on affine points against the
          python curve at 16384; the time of each level's launch
  msm     msm_device_v3 at n = 2^14 .. 2^18 on Pallas and Vesta (the
          sizes the e2e and the workload suite commit) against the native
          host MSM, msm_device_v3_rows at R = 4, n = 4096; exact.  The
          window sums timed with CUDA events, the whole call (with its
          copy back) and the native host MSM with host timers, and the
          basis upload; one chunk of the plain pipeline on the card (a
          check of the algorithm, no yardstick of speed)
  poseidon  K5 (csrc/poseidon.cu) at t = 5, B = 2^19 (the 1 MB document's
          Merkle leaves) and t = 9, B = 2^19 against its dense plain
          version on a 4,096-state sample plus the last state; both of
          its launches (a thread per state on sparse partial rounds, a
          block per state on the dense ones) at t = 5 and 9 on both
          fields on edge states (lanes 0, 1 and p - 1, as values and as
          Montgomery words), at B = 1, 2, 37 and the crossover -1, 0, +1
          against the plain version and a few states against the python
          host permutation, and at t = 5 the mesh step's batch a shard
          on a sample; exact.  The thread-per-state launch timed at
          (5, 8, 2^19), (9, 8, 2^19) and bench.py's batch (5, 8, 2^14),
          each beside its bound at the multiply-adds it runs (the
          sparse rounds' wide products and Pasta REDCs) and at the dense
          order's count of Montgomery products; the sweep of both launches'
          times over B = 2^0..2^15 that set the crossover
          (poseidon_kernel.THREAD_MIN_B)
  sumcheck  a full device nlookup_prove on 2^14 and 2^16 tables against
          the host route (exact transcript, both routes timed); K6
          (csrc/sumcheck.cu: coefficients, fold, eq step) against the
          plain versions at half = 2^19, and the coefficient launch at
          every half 2^19..1 with and without a sponge state, one launch
          a round, each round's device time; the fold and the eq step at
          every half too
  merkle  build_tree_device of the 1 MB DNA document (2^19 leaves, one K5
          launch per level), timed; a 64 Ki-entry document's root equal
          to the host MerkleCommitment
  step    the flagship device_step at B = 2^19, half = 2^19 against the
          plain versions
  field   K3 and K4 (csrc/mont.cu) at B = 2^20 on both fields against
          limb.mul and limb.redc_cols: random elements with the lanes 0,
          1 and p-1, then schoolbook product columns and columns below
          2^31 of values in [pR, 5p^2); exact, a few lanes against python
          ints
  pippenger  the v2 Pippenger msm_device (ec/msm_pippenger.py, its point
          adds' products on K3) at n = 2^16 on Pallas (8 chunks of 8192)
          and 2^14 on Vesta against the native host MSM; exact, K3 must
          have launched, no plain product may have run on the card, and
          limb.mul must be the plain function again
  mxu     the MXU Poseidon (ops/poseidon_mxu.py) under
          field_kernel.enabled(redc=True) at t = 5, B = 2^14 and 2^19,
          and t = 9, B = 4096 on both fields, against K5 on the same
          states; exact, K3 and K4 must have launched and no plain
          product or REDC may have run on the card; permutations/s
  msm_aux the binary msm.msm_device (its point adds on K1) at n = 256 and
          msm_pallas (K1) at n = 2048 against the native host MSM;
          exact, timed, K1 must have launched (both are off-path)
  ipa     the IPA round kernels (csrc/ipa.cu) at the compressed SNARK's
          two proofs (Pallas 2^16, Vesta 2^14) over the resident
          `reef/g/pv` basis: the expanded scalars, the cross dots and
          the fold of the first, a middle (n = 2^9) and the last round
          against their plain versions on the card, and the window
          combine on the window sums msm_v3.msm_windows gives for the
          first and the last round's own scalars; exact, one launch
          each.  Each kernel's device time at the first round, beside
          its bound
  mesh    the multi-device prover (reef_tpu_torch/parallel/mesh.py) on a
          mesh of every CUDA device where torch sees more than one, else
          of eight shards on the one card: the sharded MSM at n = 2^16 on
          Pallas and 2^14 on Vesta against the native host MSM and
          msm_device_v3; the sharded nlookup sumcheck on a 2^20-entry
          table (split by its low bits) against the host route's
          transcript; sharded_prover_step at B = half = 2^19 against
          device_step and its point sum against the python curve; then
          dryrun_multichip on the mesh (a real SAFA's sumcheck, an MSM, and
          a small document proved and verified with both sharded routes
          forced).  Exact; each part timed beside its single-device
          counterpart on the same card (with shards that share a card,
          what splitting costs, not scaling)
  e2e     `cli dna --e2e` in-process with the routes at their defaults
          (backend/routes.py) on the 1 MB document of the
          reference's dna.sh workload (seed 42); must prove and verify,
          and every kernel of its path (K1, K2, K5, K6, the IPA
          rounds'; K3 and K4 run off it, in their own phases) must have
          launched (the IPA rounds of the compressed SNARK's two proofs
          on the card, each of their four kernels once a round; the
          2^20-entry document sumcheck runs on the card: K5's
          block-per-state launch once a round, counted apart as
          `poseidon_spread`; K1 only in its halving reduces, one a
          chunk and one an MSM; one coefficient launch a round).  The
          device MSMs and the device sumcheck are timed; then the same
          run is timed again in the warm process, with both routes on the
          host (the policy routes.ALL_HOST) and on the
          card, and once more on the card under torch.profiler: each
          kernel's device time over one warm e2e, by name.  Last, the same
          run on the mesh phase's devices as the process mesh: it must
          prove and verify, sharded_msm and the sharded sumcheck rounds
          must each have run, and K1, K2, K5, K6 and the IPA rounds'
          kernels must have launched in it (its counts, set to 0 just
          before it, are `mesh_launches`; the compressed SNARK's IPA
          rounds run on the mesh's engine, ec/ipa_device.py `IpaMesh`)
  reject  the cold e2e run's own .cmt/.proof pair (made with K1, K2, K5's
          block-per-state launch and K6 on the card), read back with
          serialize.load: it must verify, and REJECT_LEAVES seeded int
          leaves of the proof, each plus one, and three hostile
          compressed points (an x off the curve, an x >= p, an unknown
          flag, each in a seeded point field of the IVC proof) must each
          be refused by the port's verifier (False or its VerifyError)
  options the CLI options no other phase proves: `-p` and `-y` alone on
          OPTION_DNA_BYTES of the dna.sh document, `--alpha-numeric`,
          `--basic-english` and `--ignore-whitespace` on
          OPTION_ASCII_BYTES of ascii text, in-process on `auto`; each
          must prove and verify, its tables must run where the sumcheck
          floor sends them, and its first device MSM and sumcheck of
          each size are held against the host after the walls
  workloads  the JAX package's workload suite through the port's runner
          (reef_tpu_torch.workloads): the nine workloads beside dna at
          WORKLOAD_SIZES, in-process through `workloads.argv_for` and
          cli.main with the routes at their defaults (auto), one line
          each (wall, device MSMs and sumchecks, the tables left on the
          host, the `--metrics` stages, its launches with the counts set
          to 0 just before it); each must verify, the first device MSM of
          each (curve, n) must equal the native host MSM and the first
          device sumcheck of each table the host rounds (both held after
          the workload's wall has stopped), merkle_negate and
          unicode_mn must make their 2^18 and 2^17 MSMs on the card, every
          table must run where the sumcheck floor sends it (proj_hybrid's
          2^14 hybrid table on the card), and K1's reduces, K2, K5's
          block-per-state launch and K6 must have launched.  Then
          merkle_negate and proj_hybrid warm on the host routes and on the
          card, in pairs of alternating order (WORKLOAD_WARM), and `python -m reef_tpu_torch.workloads all --serve --size
          1000` in a process of its own (one serve worker on the card for
          all ten workloads), which must exit 0 with every proof verified
  roles   the party roles in processes of their own
          (tools/card_pairs.py): ROLES_CASES' `cli --commit`, `--prove` and
          `--verify` on the card with the routes on `auto`, each role
          timed: `password`, and the resumed prover (an ascii document,
          `-b 2`, a checkpoint every four folds; its first prove process
          is killed as soon as the checkpoint appears, a second one must
          resume after at least four folds, and its proof must verify).
          Each prove process must have launched K2 and K1's reduce, the
          killed one before its checkpoint.  Then
          the port's `--verify`, through one `cli serve` worker, over every
          pair of tests/data/card_pairs.json (made on the card and by the
          JAX package): each must pass
  card_tests  `python -m pytest --noconftest -p no:cacheprovider -m cuda
          tests/test_torch_card_*.py` in a process of its own, which
          imports no JAX: every kernel against its plain version and
          python ints, as the tests hold them; it must exit 0 with every
          collected test passed and none skipped

Then the bound of each kernel row at the card's integer rate as one JSON
line, the card's name and power limit, the kernel table as one JSON line
(its `launches` are the single-device e2e's, `suite_launches` the
workload suite's in-process pass, `options_launches`, `reject_launches`,
`roles_launches` (its prove processes') and `card_tests_launches` those
phases'), and as the last line
{"ok": true,
"device": {...}}.  Kernel times are
CUDA events around a run of launches; `device_ms` queues the launches
behind a sleep on the card first, so that a short kernel's time is not
its host's issue rate.  Needs torch with
CUDA, nvcc (CUDA_HOME or /usr/local/cuda) and g++; imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import copy
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
from functools import partial

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_INT_OPS_PER_S = 67e12      # non-tensor 32-bit rate (fp32 table row)
# 32-bit integer multiply-adds (IMAD, and madc) a clock per SM on compute
# capability 9.0: half the FP32 rate (the CUDA C Programming Guide's
# arithmetic-instruction throughput table); times 132 SMs and the SM clock
H100_SMS, IMADS_PER_CLOCK_PER_SM = 132, 64
SM_CLOCK_MHZ = [1980.0]         # nvidia-smi clocks.max.sm, read in main
MULS_PER_PADD, MULS_PER_AFFINE_ADD = 14, 10
# a Montgomery product (csrc/field.cuh): 8 CIOS rounds of two 8-limb
# multiply-add chains (lo and hi halves: 32 mads) plus one m = t0*n0
MADS_PER_MUL = 8 * (2 * 2 * 8 + 1)
# K5's THREAD launch takes no fe_mul: a wide product (field.cuh wide_mul,
# wide_mac) is 8 x 8 limb products, lo and hi halves, and a Pasta-shaped
# REDC (pasta_redc) 8 rounds of 3 limb products, lo and hi halves
MADS_PER_WIDE, MADS_PER_PASTA_REDC = 2 * 8 * 8, 8 * 2 * 3
R_F, R_P = 8, {5: 56, 9: 57}    # Poseidon full and partial rounds


def poseidon_muls(t: int) -> int:
    """Products of one permutation as K5's THREAD launch runs it (sparse
    partial rounds): the S-box (3 products) on every lane of the R_F full
    rounds and t^2 products of their dense mix; in each partial round the
    lane-0 S-box, the lane-0 row (t) and one product on each other lane
    (t - 1).  992 at t = 5, 2,004 at t = 9."""
    return R_F * (3 * t + t * t) + R_P[t] * (3 + 2 * t - 1)


def poseidon_redcs(t: int) -> int:
    """REDCs of one permutation in K5's THREAD launch: one for each
    S-box product, one a row of a full round's mix (4 t a full round);
    in each partial round three for the lane-0 S-box, one for the lane-0
    row and one for each other lane (t + 3).  608 at t = 5, 972 at
    t = 9."""
    return R_F * 4 * t + R_P[t] * (t + 3)


def poseidon_thread_mads(t: int) -> int:
    """Multiply-adds of one permutation in K5's THREAD launch: its wide
    products and its Pasta-shaped REDCs.  156,160 at t = 5, 303,168 at
    t = 9."""
    return (poseidon_muls(t) * MADS_PER_WIDE
            + poseidon_redcs(t) * MADS_PER_PASTA_REDC)


def poseidon_muls_dense(t: int) -> int:
    """Products of one permutation in the dense order, as K5's SPREAD
    launch runs it: t^2 products of the mix in every round.  1,888 at
    t = 5, 5,652 at t = 9."""
    return R_F * (3 * t + t * t) + R_P[t] * (3 + t * t)


DNA_MOTIF = "ATGGGCTACAGAAACCGTGCCAAA"
# the shapes of each phase (module constants, so a rehearsal on the CPU
# can shrink them)
PADD_LANES = 1 << 16
PADD_CHECK_B = (1, 2, 37, 8192)
PADD_SWEEP_LOG = 16
# the MSM's two K1 reduces: (A, L, C, acc) of (3, 8, A, L, C) -> (3, 8, A,
# C), W = 32 windows, L = 16 Fenwick levels (log2 16384 + 1, padded) over
# DP = 256 digits, then the 256 digits
REDUCE_SHAPES = {"fenwick": (32, 16, 256, True), "digits": (32, 256, 1, False)}
SUMCHECK_KERNEL_LOG = 19
TREE_CAP = 16384
TREE_CHECK = {"pallas": (4096, 16384, 65536), "vesta": (4096, 16384)}
MSM_N = 1 << 16                 # the tree phase's points, the plain chunk's
# msm_device_v3 against the native host MSM: the 1 MB DNA e2e's 2^14 and
# 2^16, and the workload suite's 2^15, 2^17 and 2^18
MSM_NS = (1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18)
ROWS, ROW_N = 4, 4096
DNA_BYTES = 1_000_000
POSEIDON_B = 1 << 19
POSEIDON_BENCH_B = 1 << 14      # bench.py bench_poseidon's batch
POSEIDON_CHECK_B = (1, 2, 37)
POSEIDON_SWEEP_LOG = 15
SAMPLE = 4096
SUMCHECK_N = (1 << 14, 1 << 16)
KERNEL_HALF = 1 << 19
MERKLE_CHECK_N = 1 << 16
STEP_B, STEP_HALF = 1 << 19, 1 << 19
FIELD_B = 1 << 20
PIPPENGER_N = {"pallas": 1 << 16, "vesta": 1 << 14}
MXU_B = (1 << 14, 1 << 19)
MXU_T9_B = 4096
AUX_BINARY_N, AUX_PALLAS_N = 256, 2048
# the mesh phase: the e2e's commit sizes, the document's sumcheck table,
# the flagship step's points a shard
MESH_MSM_N = {"pallas": 1 << 16, "vesta": 1 << 14}
MESH_SUMCHECK_N = 1 << 20
MESH_STEP_PTS = 2
# the e2e's kernels: K1, K2, K5, K6 and the IPA rounds' (K3 and K4 run
# off its path; a mesh keeps the IPA rounds on the host)
IPA_KERNELS = ("ipa_scalars", "ipa_dots", "ipa_combine", "ipa_fold")
MESH_E2E_KERNELS = ("padd", "padd_reduce", "msm_tree", "poseidon",
                    "poseidon_spread",
                    "sumcheck_coeffs", "sumcheck_fold", "sumcheck_eq")
E2E_KERNELS = MESH_E2E_KERNELS + IPA_KERNELS
# the IPA phase: the compressed SNARK's two proofs (curve, log2 n), and
# the middle round checked
IPA_MAIN = (("pallas", 16), ("vesta", 14))
IPA_MID_N = 1 << 9
# the workload suite (reef_tpu_torch.workloads): each workload's size on
# the card (BASELINE.json configs 4-5 at 100 KB, dkim at the reference
# script's 1024; password and pihole ignore it), the device MSMs two of them
# must make, the workload whose hybrid table the sumcheck floor sends to
# the card, the two timed again warm on the host and on the card (pairs of
# runs each, host first in even pairs and card first in odd ones), and the
# kernels the pass must launch (K1 only in its reduces: each workload's
# 512-value commit is pinned to the host)
WORKLOAD_SIZES = {"password": 0, "pihole": 0, "dkim": 1024,
                  "zombie_date": 1000, "unicode": 1000,
                  "proj_hybrid": 102400, "unicode_proj": 102400,
                  "unicode_mn": 102400, "merkle_negate": 102400}
WORKLOAD_MSM_N = {"merkle_negate": 1 << 18, "unicode_mn": 1 << 17}
WORKLOAD_HYBRID = "proj_hybrid"
WORKLOAD_WARM = {"merkle_negate": 2, "proj_hybrid": 4}
WORKLOAD_MSM_KERNELS = ("padd_reduce", "msm_tree")
WORKLOAD_SUMCHECK_KERNELS = ("poseidon_spread", "sumcheck_coeffs",
                             "sumcheck_fold", "sumcheck_eq")
# every workload, dna included, through one serve worker on the card
SERVE_ARGS = ("all", "--serve", "--size", "1000")
SERVE_TIMEOUT_S = 420
# the CLI options no other phase proves, each on the routes' defaults
# (auto): the proof modes on a DNA document of OPTION_DNA_BYTES, the
# character transforms on an ascii one of OPTION_ASCII_BYTES
OPTION_DNA_BYTES = 102400
OPTION_ASCII_BYTES = 8192
OPTION_TEXT = "Hello World, hello REEF reef! "
# (alphabet, flags, regex of a document of n bytes); the -p document's
# motif sits after a skip, as in dna.sh
OPTIONS = {
    "-p": ("dna", ["-p"], lambda n: f"^.{{{n - len(DNA_MOTIF)}}}{DNA_MOTIF}.*"),
    "-y": ("dna", ["-y"], lambda n: f".*{DNA_MOTIF}.*"),
    "--alpha-numeric": ("ascii", ["--alpha-numeric"],
                        lambda n: "^HelloWorld.*REEFreef$"),
    "--basic-english": ("ascii", ["--basic-english"],
                        lambda n: "^Hello World, hello.*reef! $"),
    "--ignore-whitespace": ("ascii", ["--ignore-whitespace"],
                            lambda n: "^HelloWorld,hello.*reef!$"),
}
# the e2e's own proof, forged: seeded int leaves mutated (one at a time)
# and hostile compressed points, each of which the verifier must refuse
REJECT_LEAVES = 16
REJECT_SEED = 20261017
# the party roles in processes of their own (tools/card_pairs.py): these
# cases made again, then every committed pair verified
ROLES_CASES = ("password", "resume")
# the card lane of the test suite: the cuda-marked tests, without JAX
CARD_TESTS = "tests/test_torch_card_*.py"
CARD_TESTS_TIMEOUT_S = 600
# a Montgomery reduction alone: 8 rounds of one 8-limb multiply-add chain
# pair (lo and hi) plus one m = t0*n0
MADS_PER_REDC = 8 * (2 * 8 + 1)


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


def device_ms(torch, fn, reps: int = 20) -> float:
    """Mean device milliseconds of fn() over `reps` runs queued behind a
    sleep on the card (long enough for the host to issue all of them), so
    that they run back to back whatever the host's speed.  Where the host
    took longer to issue them than the sleep lasted (a stalled host), the
    sleep is doubled and the runs made again, up to three times."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_s = 2 * reps * (time.perf_counter() - t0) + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda._sleep(int(2e9 * sleep_s))     # ~1 s per 2e9 cycles
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        issued_s = time.perf_counter() - t0
        end.synchronize()
        if issued_s < sleep_s:
            break
        sleep_s *= 2
    return start.elapsed_time(end) / reps


def int_bound_ms(mads: int) -> float:
    """Least time for `mads` 32-bit multiply-adds at the card's integer
    rate (IMADS_PER_CLOCK_PER_SM x H100_SMS x the SM clock)."""
    rate = IMADS_PER_CLOCK_PER_SM * H100_SMS * SM_CLOCK_MHZ[0] * 1e6
    return mads / rate * 1e3


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


def max_err(a, b) -> int:
    """Largest absolute difference of two int32 limb tensors."""
    return int((a.long() - b.long()).abs().max())


def dna_text(size: int) -> str:
    """The reference's dna.sh document of `size` bytes (seed 42): random
    ACGT, then the motif."""
    body = "".join(random.Random(42).choice("ACGT")
                   for _ in range(size - len(DNA_MOTIF)))
    return body + DNA_MOTIF


def sample_idx(torch, B: int, g, dev):
    """SAMPLE - 1 random lanes of B, then the last lane."""
    return torch.cat([torch.randperm(B, generator=g)[:SAMPLE - 1],
                      torch.tensor([B - 1])]).to(dev)


def tree_split(torch, ck, placed, reps: int):
    """Mean ms of K2's launch for each level, one host call a level with
    CUDA events between them."""
    from reef_tpu_torch.ec import msm_v3
    out = torch.empty((3,) + tuple(placed.shape[1:]), dtype=torch.int32,
                      device=placed.device)
    plan = msm_v3.tree_plan(placed.shape[3])
    for lvl in plan:
        msm_v3.tree_launch(ck, placed, out, [lvl])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(plan) + 1)]
    tot = [0.0] * len(plan)
    for _ in range(reps):
        ev[0].record()
        for i, lvl in enumerate(plan):
            msm_v3.tree_launch(ck, placed, out, [lvl])
            ev[i + 1].record()
        ev[-1].synchronize()
        for i in range(len(plan)):
            tot[i] += ev[i].elapsed_time(ev[i + 1])
    return [x / reps for x in tot]


def padd_pairs(torch, ck, dev, B: int, rnd):
    """(3, 8, B) projective points P, Q (Z != 1: sums of the chip_smoke
    generators) whose lanes 0..4 are 0 + 0, 0 + Q, P + 0, P + P and
    P + (-P)."""
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec.padd import padd_soa_plain
    cv = ck.curve
    gens = PedersenGens(cv, b"chip_smoke/padd", B).G
    A = points_of(ck, gens, dev, torch)
    perm = list(range(B))
    rnd.shuffle(perm)
    Bp = points_of(ck, [gens[i] for i in perm], dev, torch)
    P = padd_soa_plain(ck, A, Bp)
    Q = padd_soa_plain(ck, Bp, padd_soa_plain(ck, A, A))
    ident = ck.ident_t(dev)
    P[:, :, 0] = ident
    Q[:, :, 0] = ident
    P[:, :, 1] = ident
    Q[:, :, 2] = ident
    Q[:, :, 3] = P[:, :, 3]
    Q[:, :, 4] = P[:, :, 4]
    y4 = ck.lf.decode32(P[1, :, 4:5])[0]
    Q[1, :, 4] = ck.lf.encode32([(-y4) % cv.p], dev)[:, 0]  # (X:-Y:Z)
    return P, Q


def phase_padd(torch, dev, curves, rnd, mesh_shapes) -> dict:
    """K1's three launches against their plain versions on both curves,
    also at the mesh path's shapes (`mesh_path_shapes`), the sweep that
    sets the crossover, and the reduces against the per-level launches
    they replace; returns the three kernel-table rows."""
    from reef_tpu_torch.ec import padd as PD
    t0 = time.perf_counter()
    B = PADD_LANES
    cross = PD.THREAD_MIN_B
    sizes = sorted(b for b in set(PADD_CHECK_B) | {cross - 1, cross,
                                                   cross + 1, B}
                   | set(mesh_shapes["padd_b"]) if b <= B)
    reduce_shapes = {**REDUCE_SHAPES, **mesh_shapes["reduce"]}
    errs = {"padd": [], "padd_spread": [], "padd_reduce": []}
    res, red, pallas = {}, {}, None
    for ck in curves:
        cv = ck.curve
        P, Q = padd_pairs(torch, ck, dev, B, rnd)
        want = PD.padd_soa_plain(ck, P, Q)
        got = PD.padd_soa(ck, P, Q, PD.THREAD)
        torch.cuda.synchronize()
        aff = ck.to_affine(got[:, :, :8].permute(2, 0, 1))
        Pa = ck.to_affine(P[:, :, :8].permute(2, 0, 1))
        Qa = ck.to_affine(Q[:, :, :8].permute(2, 0, 1))
        require(aff == [cv.add(a, b) for a, b in zip(Pa, Qa)],
                f"padd {cv.name}: lanes 0..7 disagree with the curve")
        require(aff[0] is None and aff[4] is None,
                f"padd {cv.name}: 0 + 0 or P + (-P) is not the identity")
        for Bs in sizes:
            p, q = P[..., :Bs].contiguous(), Q[..., :Bs].contiguous()
            for path, name in ((PD.THREAD, "padd"),
                               (PD.SPREAD, "padd_spread")):
                errs[name].append(max_err(PD.padd_soa(ck, p, q, path),
                                          want[..., :Bs]))
                require(errs[name][-1] == 0, f"padd {cv.name} B={Bs} path "
                        f"{path}: kernel != plain (max {errs[name][-1]})")
        # the reduces at the MSM's and the mesh's shapes, over sums with
        # the special lanes
        for shape, (A, L, C, has_acc) in reduce_shapes.items():
            idx = torch.arange(A * L * C, device=dev) * 7 % B
            X = want[:, :, idx].reshape(3, 8, A, L, C).contiguous()
            acc = (want[:, :, idx[:A * C].flip(0)].reshape(3, 8, A, C)
                   .contiguous() if has_acc else None)
            plain = PD.padd_reduce_plain(ck, X, acc)
            errs["padd_reduce"].append(max_err(PD.padd_reduce(ck, X, acc),
                                               plain))
            require(errs["padd_reduce"][-1] == 0, f"padd_reduce {cv.name} "
                    f"{shape}: kernel != per-level loop")
            if cv.name == "pallas":
                # against the per-level launches it replaced: one K1 add
                # launch (THREAD, or routed) of contiguous copies a level
                red[shape] = {
                    "ms": device_ms(torch, lambda: PD.padd_reduce(ck, X,
                                                                  acc)),
                    "per_level_thread_ms": device_ms(
                        torch, lambda: PD.padd_reduce_plain(
                            ck, X, acc, partial(PD.padd_soa,
                                                path=PD.THREAD))),
                    "per_level_routed_ms": device_ms(
                        torch, lambda: PD.padd_reduce_plain(
                            ck, X, acc, PD.padd_soa)),
                    "plain_ms": cuda_ms(torch, lambda: PD.padd_reduce_plain(
                        ck, X, acc), reps=1)}
        res[cv.name] = {
            "ms": cuda_ms(torch, lambda: PD.padd_soa(ck, P, Q, PD.THREAD),
                          reps=20),
            "plain_ms": cuda_ms(torch, lambda: PD.padd_soa_plain(ck, P, Q),
                                reps=2)}
        if cv.name == "pallas":
            pallas = (ck, P, Q)
    # the sweep that set THREAD_MIN_B: both add launches on Pallas
    ck, P, Q = pallas
    sweep = {}
    for k in range(PADD_SWEEP_LOG + 1):
        p, q = P[..., :1 << k].contiguous(), Q[..., :1 << k].contiguous()
        sweep[str(1 << k)] = [device_ms(torch, lambda: PD.padd_soa(
            ck, p, q, path)) for path in (PD.THREAD, PD.SPREAD)]
    Bs = PADD_CHECK_B[-1]
    p, q = P[..., :Bs].contiguous(), Q[..., :Bs].contiguous()
    spread_ms = device_ms(torch, lambda: PD.padd_soa(ck, p, q, PD.SPREAD))
    spread_plain = cuda_ms(torch, lambda: PD.padd_soa_plain(ck, p, q),
                           reps=2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit("padd", t0, lanes=B, checked_lanes=sizes,
         thread_min_b=PD.THREAD_MIN_B, reduce=red,
         reduce_plan={shape: PD.reduce_plan(A * C, L, has_acc, sms)
                      for shape, (A, L, C, has_acc)
                      in reduce_shapes.items()},
         sweep_ms_thread_spread=sweep, **res)
    mads = MULS_PER_PADD * MADS_PER_MUL
    common = {"route": "cuda", "source": "reef_tpu_torch/csrc/padd.cu",
              "replaces": "reef_tpu/ec/pallas_ec.py:151", "library_ms": None}
    bms, by = bound_ms(B * 3 * 96, B * mads)
    sbms, sby = bound_ms(Bs * 3 * 96, Bs * mads)
    rows = {
        "padd": {"name": "padd", **common,
                 "max_abs_err": max(errs["padd"]),
                 "ms": res["pallas"]["ms"],
                 "plain_ms": res["pallas"]["plain_ms"],
                 "bound_ms": bms, "bound_by": by,
                 "int_bound_ms": int_bound_ms(B * mads),
                 "shape": f"(3, 8, {B}) int32, Pallas, the THREAD launch; "
                          f"launches: every K1 launch"},
        "padd_spread": {"name": "padd_spread", **common,
                        "max_abs_err": max(errs["padd_spread"]),
                        "ms": spread_ms, "plain_ms": spread_plain,
                        "bound_ms": sbms, "bound_by": sby,
                        "int_bound_ms": int_bound_ms(Bs * mads),
                        "shape": f"(3, 8, {Bs}) int32, Pallas, the SPREAD "
                                 f"launch (six threads an add)"}}
    shapes = {}
    for shape, (A, L, C, has_acc) in reduce_shapes.items():
        adds = A * C * (L - 1 + has_acc)
        nb = (A * L * C + A * C * (1 + has_acc)) * 96
        b_ms, b_by = bound_ms(nb, adds * mads)
        shapes[shape] = {**red[shape], "bound_ms": b_ms, "bound_by": b_by,
                         "int_bound_ms": int_bound_ms(adds * mads),
                         "shape": f"(3, 8, {A}, {L}, {C}) -> (3, 8, {A}, "
                                  f"{C}){' + acc' if has_acc else ''}"}
    fen = shapes["fenwick"]
    rows["padd_reduce"] = {
        "name": "padd_reduce", **common,
        "replaces": "reef_tpu/ec/pallas_ec.py:151 (one _padd_call a level "
                    "of reef_tpu/ec/msm_v3.py:323-329 and :357)",
        "max_abs_err": max(errs["padd_reduce"]), "ms": fen["ms"],
        "plain_ms": fen["plain_ms"], "bound_ms": fen["bound_ms"],
        "bound_by": fen["bound_by"], "int_bound_ms": fen["int_bound_ms"],
        "shape": fen["shape"] + ", Pallas (the Fenwick reduce)",
        "shapes": shapes}
    return rows


def phase_tree(torch, dev, curves, mesh_shapes) -> dict:
    """K2 against its plain version at every cap of TREE_CHECK and of the
    mesh path (`mesh_path_shapes`) on its curves, all 32 windows, exact
    on every node; at TREE_CAP spot-checked
    on affine points against the python curve, and timed: a call and
    each level's launch.  Returns its kernel-table row."""
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm_v3
    t0 = time.perf_counter()
    W = msm_v3.N_WINDOWS
    g = torch.Generator(device="cpu").manual_seed(7)
    res, errs = {}, []
    checked = {name: sorted(set(caps) | set(mesh_shapes["tree_caps"][name]))
               for name, caps in TREE_CHECK.items()}
    for ck in curves:
        cv = ck.curve
        gens = PedersenGens(cv, b"chip_smoke/msm", MSM_N).G
        for cap in checked[cv.name]:
            base = points_of(ck, gens[:cap], dev, torch)    # (3, 8, cap)
            order = torch.stack([torch.randperm(cap, generator=g)
                                 for _ in range(W)]).to(dev)  # (W, cap)
            placed = base[:2][:, :, order].contiguous()     # (2, 8, W, cap)
            got = msm_v3.tree_levels(ck, placed)
            want = msm_v3.tree_levels_plain(ck, placed)
            torch.cuda.synchronize()
            errs.append(max_err(got[..., :cap - 1], want[..., :cap - 1]))
            require(errs[-1] == 0, f"tree {cv.name} cap={cap}: kernel != "
                    f"plain (max {errs[-1]})")
            if cap != TREE_CAP:
                continue
            # affine spot checks: level-1 node 0 and the root of windows 0
            # and W-1
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
            ms = cuda_ms(torch, lambda: msm_v3.tree_levels(ck, placed),
                         reps=10)
            plain_ms = cuda_ms(torch, lambda: msm_v3.tree_levels_plain(
                ck, placed), reps=1)
            res[cv.name] = {"ms": ms, "plain_ms": plain_ms,
                            "level_ms": tree_split(torch, ck, placed,
                                                   reps=10)}
    emit("tree", t0, cap=TREE_CAP, checked_caps=checked, windows=W, **res)
    cap = TREE_CAP
    n_aff, n_full = W * cap // 2, W * (cap // 2 - 1)
    tree_mads = ((n_aff * MULS_PER_AFFINE_ADD + n_full * MULS_PER_PADD)
                 * MADS_PER_MUL)
    bms, by = bound_ms(W * cap * 2 * 32 + W * (cap - 1) * 96, tree_mads)
    pallas = res["pallas"]
    return {
        "name": "msm_tree", "route": "cuda",
        "source": "reef_tpu_torch/csrc/msm_tree.cu",
        "replaces": "reef_tpu/ec/msm_v3.py:182",
        "max_abs_err": max(errs), "ms": pallas["ms"],
        "plain_ms": pallas["plain_ms"], "bound_ms": bms, "bound_by": by,
        "int_bound_ms": int_bound_ms(tree_mads), "library_ms": None,
        "shape": f"(2, 8, {W}, {cap}) -> (3, 8, {W}, {cap}) int32, Pallas"}


def phase_poseidon(torch, dev, mesh_shapes) -> dict:
    """K5's two launches against the dense plain version, edge states
    included, and at t = 5 the mesh step's batch a shard
    (`mesh_path_shapes`) on a sample; returns its kernel-table row."""
    from reef_tpu_torch.models.prover_step import random_elems
    from reef_tpu_torch.ops import limb, poseidon_device
    from reef_tpu_torch.ops import poseidon_kernel as PK
    from reef_tpu_torch.ops.poseidon_constants import host_permutation
    permute, plain = poseidon_device.permute, poseidon_device.permute_plain
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(5)

    def states(t, B):
        return random_elems((t, B), g, dev).permute(1, 0, 2).contiguous()

    def edge_states(f, t):
        """Every lane 0, 1, p - 1, or the value whose Montgomery word is 1
        or p - 1 (the largest word a lazy row sums); then 0, 1 and p - 1
        cycled across the lanes."""
        p = f.p_int
        rows = [[v] * t for v in (0, 1, p - 1, f.unmont(1), f.unmont(p - 1))]
        rows += [[(0, 1, p - 1)[(l + k) % 3] for l in range(t)]
                 for k in range(3)]
        return torch.stack([f.encode32([r[l] for r in rows], dev)
                            for l in range(t)])

    def host_check(lf, X, Y, lanes):
        for b in lanes:
            s = [lf.decode32(X[l, :, b:b + 1])[0] for l in range(X.shape[0])]
            out = [lf.decode32(Y[l, :, b:b + 1])[0] for l in range(X.shape[0])]
            require(out == host_permutation(lf.p_int, s),
                    f"poseidon {lf.name}: state {b} != host permutation")

    lf = limb.FQ
    B = POSEIDON_B
    X = states(5, B)
    idx = sample_idx(torch, B, g, dev)
    got = permute(lf, X)
    Xs = X[:, :, idx].contiguous()
    err = max_err(got[:, :, idx], plain(lf, Xs))
    require(err == 0, f"poseidon t=5: kernel != plain (max {err})")
    host_check(lf, X, got, (0, B - 1))
    ms5 = cuda_ms(torch, lambda: permute(lf, X), reps=5)
    plain5 = cuda_ms(torch, lambda: plain(lf, Xs), reps=1)
    errs = [err]
    for Bs in mesh_shapes["poseidon_b"]:
        Xb = X[:, :, :Bs].contiguous()
        ib = idx[idx < Bs]
        errs.append(max_err(permute(lf, Xb)[:, :, ib],
                            plain(lf, Xb[:, :, ib].contiguous())))
        require(errs[-1] == 0, f"poseidon t=5 B={Bs}: kernel != plain "
                f"(max {errs[-1]})")
    # THREAD at t = 9 and at bench.py's batch, timed
    X9 = states(9, B)
    idx9 = sample_idx(torch, B, g, dev)
    got9 = PK.launch(lf, X9, PK.THREAD)
    X9s = X9[:, :, idx9].contiguous()
    errs.append(max_err(got9[:, :, idx9], plain(lf, X9s)))
    require(errs[-1] == 0, f"poseidon t=9 B={B}: kernel != plain "
            f"(max {errs[-1]})")
    host_check(lf, X9, got9, (0, B - 1))
    ms9_big = cuda_ms(torch, lambda: PK.launch(lf, X9, PK.THREAD), reps=3)
    plain9_big = cuda_ms(torch, lambda: plain(lf, X9s), reps=1)
    Xb = X[:, :, :POSEIDON_BENCH_B].contiguous()
    require(torch.equal(PK.launch(lf, Xb, PK.THREAD),
                        got[:, :, :POSEIDON_BENCH_B]),
            "poseidon t=5: the bench batch != the same states at 2^19")
    ms5_bench = cuda_ms(torch, lambda: PK.launch(lf, Xb, PK.THREAD),
                        reps=20)
    # both launches at every B of POSEIDON_CHECK_B and around the
    # crossover, and on the edge states, against one plain run over all
    # those states
    n_edge = 0
    for f in (limb.FQ, limb.FP):
        for t in (5, 9):
            cross = PK.THREAD_MIN_B
            sizes = sorted(set(POSEIDON_CHECK_B) | {cross - 1, cross,
                                                    cross + 1})
            E = edge_states(f, t)
            n_edge += E.shape[2]
            Ys = [E] + [states(t, Bs) for Bs in sizes]
            want = plain(f, torch.cat(Ys, dim=2))
            for path in (PK.THREAD, PK.SPREAD):
                gots = torch.cat([PK.launch(f, Y, path) for Y in Ys], dim=2)
                errs.append(max_err(gots, want))
                require(errs[-1] == 0, f"poseidon t={t} {f.name} path "
                        f"{path}: kernel != plain (max {errs[-1]})")
            host_check(f, E, PK.launch(f, E, PK.THREAD),
                       range(E.shape[2]))
            host_check(f, Ys[1], PK.launch(f, Ys[1], PK.SPREAD), (0,))
            host_check(f, Ys[-1], PK.launch(f, Ys[-1], PK.THREAD),
                       (sizes[-1] - 1,))
    # the sweep that set THREAD_MIN_B: both launches on Fq at B = 2^k
    sweep = {}
    for t in (5, 9):
        for k in range(POSEIDON_SWEEP_LOG + 1):
            Y = states(t, 1 << k)
            sweep[f"t{t}_b{1 << k}"] = [
                cuda_ms(torch, lambda: PK.launch(lf, Y, path),
                        reps=max(3, 20 >> k))
                for path in (PK.THREAD, PK.SPREAD)]
    Y1 = states(9, 1)
    ms9 = cuda_ms(torch, lambda: permute(lf, Y1), reps=50)
    thread9 = cuda_ms(torch, lambda: PK.launch(lf, Y1, PK.THREAD), reps=10)
    plain9 = cuda_ms(torch, lambda: plain(lf, Y1), reps=1)
    # THREAD runs the sparse rounds on wide products and Pasta REDCs,
    # SPREAD the dense ones on fe_mul; beside THREAD's bounds, the int
    # bound of the dense order on fe_mul
    bounds = {}
    for t, Bt in ((5, B), (9, B), (5, POSEIDON_BENCH_B)):
        mads = Bt * poseidon_thread_mads(t)
        bounds[f"t{t}_b{Bt}"] = {
            "bound_ms": bound_ms(2 * t * 32 * Bt, mads)[0],
            "int_bound_ms": int_bound_ms(mads),
            "int_bound_ms_dense_count": int_bound_ms(
                Bt * poseidon_muls_dense(t) * MADS_PER_MUL)}
    bms5, by5 = bound_ms(2 * 5 * 32 * B, B * poseidon_thread_mads(5))
    bms9, by9 = bound_ms(2 * 9 * 32, poseidon_muls_dense(9) * MADS_PER_MUL)
    emit("poseidon", t0, t5_states=B, t5_ms=ms5, t5_bound_ms=bms5,
         t5_plain_ms_on_sample=plain5, sample=SAMPLE,
         t9_b2e19_thread_ms=ms9_big, t9_plain_ms_on_sample=plain9_big,
         t5_b2e14_thread_ms=ms5_bench,
         t5_b2e14_states_per_s=POSEIDON_BENCH_B / ms5_bench * 1e3,
         thread_bounds=bounds, products={
             t: [poseidon_muls(t), poseidon_muls_dense(t)] for t in (5, 9)},
         thread_redcs={t: poseidon_redcs(t) for t in (5, 9)},
         thread_mads={t: poseidon_thread_mads(t) for t in (5, 9)},
         edge_states=n_edge, t9_b1_ms=ms9,
         t9_b1_thread_ms=thread9, t9_b1_bound_ms=bms9,
         t9_b1_plain_ms=plain9, t5_states_per_s=B / ms5 * 1e3,
         thread_min_b=PK.THREAD_MIN_B,
         checked_t5_b=[B, *mesh_shapes["poseidon_b"]],
         sweep_ms_thread_spread=sweep)
    return {
        "name": "poseidon", "route": "cuda",
        "source": "reef_tpu_torch/csrc/poseidon.cu",
        "replaces": "reef_tpu/ops/poseidon_pallas.py:185",
        "max_abs_err": max(errs), "ms": ms9, "plain_ms": plain9,
        "bound_ms": bms9, "bound_by": by9, "library_ms": None,
        "int_bound_ms": int_bound_ms(poseidon_muls_dense(9) * MADS_PER_MUL),
        "shape": "(9, 8, 1) int32, Fq: a sumcheck round's sponge (the "
                 "SPREAD launch, dense rounds)",
        "t9_b1_thread_ms": thread9,
        "t5_b2e19_ms": ms5, "t5_b2e19_bound_ms": bms5,
        "t5_b2e19_bound_by": by5, "t5_plain_ms_on_4096": plain5,
        "t9_b2e19_ms": ms9_big, "t9_plain_ms_on_4096": plain9_big,
        "t5_b2e14_ms": ms5_bench,
        "thread_bounds": bounds}


def phase_sumcheck(torch, dev, rnd) -> dict:
    """A device nlookup_prove against the host route, and K6 against its
    plain versions; returns the three kernel-table rows."""
    from reef_tpu_torch.backend import sumcheck as SC
    from reef_tpu_torch.models.prover_step import random_elems
    from reef_tpu_torch.ops import field as F
    from reef_tpu_torch.ops import limb
    from reef_tpu_torch.ops import sumcheck_kernel as K
    from reef_tpu_torch.ops.sumcheck_device import DeviceTableCache
    from reef_tpu_torch.utils import cudabuild
    t0 = time.perf_counter()
    f, lf = F.FQ, limb.FQ
    routes = {}
    for n in SUMCHECK_N:
        table = [rnd.randrange(4) for _ in range(n)]
        qs = [rnd.randrange(n) for _ in range(64)]
        qs[5] = qs[2]
        vs = [table[q] for q in qs]
        ell = n.bit_length() - 1
        prev_q = [rnd.randrange(f.p) for _ in range(ell)]
        prev_v = SC.verifier_mle_eval(f, table, prev_q)
        args = (f, table, qs, vs, prev_q, prev_v, "nldoc", 12345)
        t1 = time.perf_counter()
        host = SC.nlookup_prove(*args)
        host_s = time.perf_counter() - t1
        cache = DeviceTableCache(lf, table, device=dev)
        secs = []
        for _ in range(2):
            t1 = time.perf_counter()
            got = SC.nlookup_prove(*args, device_cache=cache)  # ends in a copy
            secs.append(time.perf_counter() - t1)
            require(got == host, f"sumcheck 2^{ell}: device transcript != "
                    f"host route")
        routes[f"table_2e{ell}"] = {"rounds": ell, "host_route_s": host_s,
                                    "device_route_s": secs}

    g = torch.Generator(device="cpu").manual_seed(6)
    half = KERNEL_HALF
    T = random_elems((2 * half,), g, dev)
    E = random_elems((2 * half,), g, dev)
    st = random_elems((9,), g, dev).T.reshape(9, limb.N32, 1).contiguous()
    r = random_elems((1,), g, dev)
    hv = (T[:, :half], T[:, half:], E[:, :half], E[:, half:])
    term = T[:, :half].contiguous()
    runs = {
        "sumcheck_coeffs": (lambda: K.coeffs(lf, *hv, st),
                            lambda: K.coeffs_plain(lf, *hv, st),
                            4 * half * 32, 3 * half),
        "sumcheck_fold": (lambda: K.fold(lf, *hv, r),
                          lambda: K.fold_plain(lf, *hv, r),
                          6 * half * 32, 2 * half),
        "sumcheck_eq": (lambda: (K.eq_step(lf, term, r, E),),
                        lambda: (K.eq_step_plain(lf, term, r, E),),
                        5 * half * 32, 2 * half),
    }
    rows, res = {}, {}
    for name, (kern, pl, nbytes, muls) in runs.items():
        got, want = kern(), pl()
        torch.cuda.synchronize()
        err = max(max_err(a, b) for a, b in zip(got, want))
        require(err == 0, f"{name}: kernel != plain (max {err})")
        ms = cuda_ms(torch, kern, reps=10)
        plain_ms = cuda_ms(torch, pl, reps=1)
        bms, by = bound_ms(nbytes, muls * MADS_PER_MUL)
        res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "int_bound_ms": int_bound_ms(muls * MADS_PER_MUL)}
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "reef_tpu_torch/csrc/sumcheck.cu",
            "replaces": ("reef_tpu/ops/sumcheck_device.py:87 (XLA, not a "
                         "pallas_call)" if name == "sumcheck_eq" else
                         "reef_tpu/ops/sumcheck_device.py:43 (XLA, not a "
                         "pallas_call)"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "int_bound_ms": res[name]["int_bound_ms"],
            "shape": f"(8, {2 * half}) int32 tables, half = {half}"}
    # the coefficient launch at every round of a 2^(LOG+1)-entry sumcheck,
    # with and without a sponge state: exact, one launch a round; the fold
    # and the eq step at every width too (the shards' and the lead's)
    rounds = []
    for lh in range(SUMCHECK_KERNEL_LOG, -1, -1):
        h = 1 << lh
        hv = (T[:, :h], T[:, h:2 * h], E[:, :h], E[:, h:2 * h])
        tm = T[:, :h].contiguous()
        for name, got, want in (
                ("fold", K.fold(lf, *hv, r), K.fold_plain(lf, *hv, r)),
                ("eq_step", (K.eq_step(lf, tm, r),),
                 (K.eq_step_plain(lf, tm, r),))):
            err = max(max_err(a, b) for a, b in zip(got, want))
            require(err == 0, f"{name} half={h}: kernel != plain "
                    f"(max {err})")
        for state in (st, None):
            before = cudabuild.launch_counts()["sumcheck_coeffs"]
            got = K.coeffs(lf, *hv, state)
            require(cudabuild.launch_counts()["sumcheck_coeffs"]
                    == before + 1, f"coeffs half={h}: not one launch")
            want = K.coeffs_plain(lf, *hv, state)
            err = max(max_err(a, b) for a, b in zip(got, want)
                      if b is not None)
            require(err == 0, f"coeffs half={h}: kernel != plain "
                    f"(max {err})")
        rounds.append(device_ms(torch, lambda: K.coeffs(lf, *hv, st)))
    rows["sumcheck_coeffs"].update(round_ms=rounds, sumcheck_ms=sum(rounds))
    emit("sumcheck", t0, **routes, half=half, **res,
         coeff_round_device_ms=rounds, coeff_sumcheck_device_ms=sum(rounds),
         coeff_launches_per_round=1,
         coeff_round_plan=[K.coeff_plan(1 << lh) for lh in
                           range(SUMCHECK_KERNEL_LOG, -1, -1)])
    return rows


def phase_merkle(torch, dev) -> None:
    """The 1 MB DNA document's tree on the card, and a 64 Ki-entry
    document's root against the host MerkleCommitment."""
    from reef_tpu_torch.backend.merkle import (MerkleCommitment,
                                               build_tree_device)
    from reef_tpu_torch.backend.table import doc_transform
    from reef_tpu_torch.utils import cudabuild
    t0 = time.perf_counter()
    ab = [ord(c) for c in "ACGT"]
    udoc = doc_transform(ab, [ord(c) for c in dna_text(DNA_BYTES)])
    before = cudabuild.launch_counts()["poseidon"]
    secs, roots = [], []
    for _ in range(2):
        t1 = time.perf_counter()
        roots.append(build_tree_device(udoc, dev))   # ends in a copy
        secs.append(time.perf_counter() - t1)
    launches = (cudabuild.launch_counts()["poseidon"] - before) // 2
    levels = (len(udoc) // 2 - 1).bit_length() + 1
    require(roots[0] == roots[1], "merkle: two builds differ")
    require(launches == levels, f"merkle: {launches} K5 launches for "
            f"{levels} levels")
    small = doc_transform(ab, [ord(c) for c in dna_text(MERKLE_CHECK_N - 2)])
    t1 = time.perf_counter()
    want = MerkleCommitment(small).commitment
    host_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    got = build_tree_device(small, dev)
    dev_s = time.perf_counter() - t1
    require(got == want, "merkle: device root != host MerkleCommitment")
    emit("merkle", t0, doc_bytes=DNA_BYTES, udoc=len(udoc),
         leaves=len(udoc) // 2, k5_launches=launches, build_s=secs,
         check_udoc=len(small), check_host_s=host_s, check_device_s=dev_s)


def phase_step(torch, dev) -> None:
    """The flagship step against the plain versions."""
    from reef_tpu_torch.models import prover_step as PS
    from reef_tpu_torch.ops import limb, poseidon_device
    from reef_tpu_torch.ops import sumcheck_kernel as K
    t0 = time.perf_counter()
    lf = limb.FQ
    states, t_tab, eq_tab, r = PS.example_args(STEP_B, STEP_HALF, seed=1,
                                               device=dev)
    out = PS.device_step(states, t_tab, eq_tab, r)
    idx = sample_idx(torch, STEP_B, torch.Generator().manual_seed(8), dev)
    hv = (t_tab[0], t_tab[1], eq_tab[0], eq_tab[1])
    g, _ = K.coeffs_plain(lf, *hv)
    want = [poseidon_device.permute_plain(lf, states[:, :, idx].contiguous()),
            *K.fold_plain(lf, *hv, r), g[0], g[1], g[2]]
    got = [out[0][:, :, idx], *out[1:]]
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(err == 0, f"step: device_step != plain (max {err})")
    ms = cuda_ms(torch, lambda: PS.device_step(states, t_tab, eq_tab, r),
                 reps=5)
    emit("step", t0, states=STEP_B, half=STEP_HALF, ms=ms, max_abs_err=err)


def mesh_devices(torch) -> list:
    """Every CUDA device where torch sees more than one, else eight shards
    on the one card (`parallel.dryrun.default_devices`)."""
    from reef_tpu_torch.parallel.dryrun import default_devices
    return default_devices()


def mesh_path_shapes(m: int) -> dict:
    """The launch shapes that a mesh of m shards gives K1, K2 and K5 in
    the mesh e2e and the mesh phase beyond the single-device e2e's: each
    curve's MESH_MSM_N commit as one chunk of n_local points a shard (K2's
    tree at a cap of msm_v3.TREE_MIN_CAP and more, else K1's per-level
    adds of W n_local / 2 .. W points) and its Fenwick reduce, the
    cross-shard reduce of the window sums (1, L, W), the step's point
    sums (1, L, 1) and the step's K5 batch a shard (t = 5, Fq)."""
    from reef_tpu_torch.ec import msm_v3
    from reef_tpu_torch.parallel.mesh import _n_local, _pow2_at_least
    W, L = msm_v3.N_WINDOWS, _pow2_at_least(m)
    caps, adds, reduce = {}, set(), {}

    def add_reduce(name, shape):
        if shape not in [*REDUCE_SHAPES.values(), *reduce.values()]:
            reduce[name] = shape

    for name, n in MESH_MSM_N.items():
        cap = min(msm_v3.DEFAULT_CAP, _n_local(n, m))
        log = cap.bit_length() - 1
        caps[name] = [cap] if cap >= msm_v3.TREE_MIN_CAP else []
        if cap < msm_v3.TREE_MIN_CAP:
            adds |= {W * (cap >> b) for b in range(1, log + 1)}
        add_reduce(f"mesh_fenwick_{cap}",
                   (W, 1 << log.bit_length(), msm_v3.DP, True))
    add_reduce("mesh_windows", (1, L, W, False))
    add_reduce("mesh_step_shard",
               (1, _pow2_at_least(MESH_STEP_PTS), 1, False))
    add_reduce("mesh_step", (1, L, 1, False))
    return {"tree_caps": caps, "padd_b": sorted(adds), "reduce": reduce,
            "poseidon_b": [STEP_B // m]}


def phase_mesh(torch, dev, curves, rnd) -> list:
    """The multi-device prover (parallel/mesh.py) at the e2e's sizes on
    `mesh_devices`: the sharded MSM against the native host MSM, the
    sharded sumcheck against the host route's transcript, the sharded
    step against device_step and the python curve, then
    dryrun_multichip; exact.  Each timed beside its single-device
    counterpart on the same card.  Returns the mesh's devices."""
    from reef_tpu_torch.backend import sumcheck as SC
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm_v3, native_msm
    from reef_tpu_torch.ec.pasta import VESTA
    from reef_tpu_torch.models import prover_step as PS
    from reef_tpu_torch.ops import field as F
    from reef_tpu_torch.ops import limb
    from reef_tpu_torch.ops.sumcheck_device import DeviceTableCache
    from reef_tpu_torch.parallel import mesh as PM
    from reef_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    mesh = PM.make_mesh(devices=mesh_devices(torch))
    m = mesh.size
    res = {}
    for ck in curves:
        cv = ck.curve
        n = MESH_MSM_N[cv.name]
        gens = PedersenGens(cv, b"chip_smoke/mesh", n)
        scalars = [rnd.randrange(cv.order) for _ in range(n)]
        sb = PM.ShardedBasis(ck, gens.G, mesh)
        basis = msm_v3.DeviceBasisV3(ck, gens.G, device=dev)
        t1 = time.perf_counter()
        got = PM.sharded_msm(mesh, ck, scalars, sb)    # ends in a copy
        sharded_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        single = msm_v3.msm_device_v3(ck, scalars, basis)
        single_s = time.perf_counter() - t1
        want = native_msm.msm_packed(cv, scalars, gens.packed_G(),
                                     handle=gens.native_basis())
        require(got == want == single, f"mesh msm {cv.name}: sharded, "
                "single-device and native host MSMs differ")
        scbs = PM.upload_sharded_scalars(sb, scalars)
        scb = msm_v3.upload_scalars(basis, [scalars])[0]
        res[f"msm_{cv.name}"] = {
            "n": n, "n_local": sb.n_local,
            "sharded_windows_ms": cuda_ms(
                torch, lambda: PM.sharded_windows(ck, sb, scbs), reps=3),
            "single_windows_ms": cuda_ms(
                torch, lambda: msm_v3.msm_windows(ck, basis, scb), reps=3),
            "sharded_call_s": sharded_s, "single_call_s": single_s}

    # the document's sumcheck: split by the low bits, against the host
    f, lf = F.FQ, limb.FQ
    n = MESH_SUMCHECK_N
    table = [rnd.randrange(4) for _ in range(n)]
    qs = [rnd.randrange(n) for _ in range(64)]
    vs = [table[q] for q in qs]
    ell = n.bit_length() - 1
    prev_q = [rnd.randrange(f.p) for _ in range(ell)]
    prev_v = SC.verifier_mle_eval(f, table, prev_q)
    args = (f, table, qs, vs, prev_q, prev_v, "nldoc", 12345)
    t1 = time.perf_counter()
    host = SC.nlookup_prove(*args)
    host_s = time.perf_counter() - t1
    caches = {"sharded": PM.sharded_table_cache(lf, table, mesh),
              "single": DeviceTableCache(lf, table, device=dev)}
    secs = {}
    for name, cache in caches.items():
        secs[name] = []
        for _ in range(2):
            t1 = time.perf_counter()
            got = SC.nlookup_prove(*args, device_cache=cache)
            secs[name].append(time.perf_counter() - t1)
            require(got == host, f"mesh sumcheck ({name}): transcript != "
                    "host route")
    eq = caches["single"].t_shards[0]
    res["sumcheck"] = {
        "n": n, "rounds_on_shards": ell - (m.bit_length() - 1),
        "host_route_s": host_s, "sharded_route_s": secs["sharded"],
        "single_route_s": secs["single"],
        "eq_split_ms": cuda_ms(torch, lambda: caches["sharded"].split(eq),
                               reps=3)}

    # the flagship step, split over the mesh, against device_step
    gen = torch.Generator().manual_seed(9)
    args = PM.sharded_example_args(mesh, gen, STEP_B // m, STEP_HALF // m,
                                   MESH_STEP_PTS)
    step = PM.sharded_prover_step(mesh)
    out = step(*args)
    want = PS.device_step(*[a.to(dev) for a in args[:4]])
    for i, (a, b) in enumerate(zip(out[:6], want)):
        require(torch.equal(a, b), f"mesh step: output {i} != device_step")
    pt_sum = None
    for i in range(args[4].shape[2]):
        pt_sum = VESTA.add(pt_sum, VESTA.mul(i + 2, VESTA.gen))
    require(curves[1].to_affine(out[6].permute(2, 0, 1).cpu().numpy())
            == [pt_sum], "mesh step: point sum != python curve")
    res["step"] = {
        "states": STEP_B, "half": STEP_HALF, "points": args[4].shape[2],
        "sharded_ms": cuda_ms(torch, lambda: step(*args), reps=3),
        "single_ms": cuda_ms(torch, lambda: PS.device_step(*args[:4]),
                             reps=3)}
    res["dryrun"] = dryrun_multichip(mesh.devices, log=lambda msg: None)
    emit("mesh", t0, devices=[str(d) for d in mesh.devices],
         note=("shards share one card: the times measure what splitting "
               "costs, not scaling" if len(set(mesh.devices)) == 1
               else "one shard a card"), **res)
    return [str(d) for d in mesh.devices]


def mxu_range_cols(torch, lf, B: int, g, dev):
    """(32, B) int64 columns, each below 2^31, of values in [pR, pR + p^2)
    within [pR, 5p^2): the MXU Poseidon's accumulations that need K4's
    second subtract.  pR plus a random product's schoolbook columns,
    carried to 16-bit limbs, then random amounts moved one column down."""
    from reef_tpu_torch.models.prover_step import random_elems
    from reef_tpu_torch.ops import field as F
    from reef_tpu_torch.ops import limb
    x = limb.split32(random_elems((B,), g, dev))
    y = limb.split32(random_elems((B,), g, dev))
    cols = torch.zeros((32, B), dtype=torch.int64, device=dev)
    for i in range(16):
        cols[i:i + 16] += x[i] * y
    cols += torch.tensor(F.to_limbs(lf.p_int << 256, 32), device=dev)[:, None]
    limb._carry_(cols)
    for k in range(31, 0, -1):
        cap = torch.clamp(cols[k], max=1 << 14) + 1
        r = (torch.rand(B, generator=g).to(dev) * cap).long()
        cols[k] -= r
        cols[k - 1] += r << 16
    return cols


def phase_field(torch, dev) -> dict:
    """K3 and K4 (csrc/mont.cu) against their plain versions on both
    fields; returns their kernel-table rows (launches filled in later)."""
    from reef_tpu_torch.models.prover_step import random_elems
    from reef_tpu_torch.ops import field as F
    from reef_tpu_torch.ops import field_kernel as FK
    from reef_tpu_torch.ops import limb
    t0 = time.perf_counter()
    B = FIELD_B
    g = torch.Generator(device="cpu").manual_seed(9)
    res = {}
    for lf in (limb.FQ, limb.FP):
        a = limb.split32(random_elems((B,), g, dev)).contiguous()
        b = limb.split32(random_elems((B,), g, dev)).contiguous()
        for lane, v in enumerate((0, 1, lf.p_int - 1)):
            a[:, lane] = torch.tensor(F.to_limbs(v), device=dev)
            b[:, B - 1 - lane] = torch.tensor(F.to_limbs(v), device=dev)
        got = FK.mont_mul(lf, a, b)
        mul_err = max_err(got, limb.mul(lf, a, b))
        require(mul_err == 0, f"mont_mul {lf.name}: kernel != plain")
        for lane in (0, 1, 2, B - 3, B - 2, B - 1, B // 3):
            x, y = (F.from_limbs(t[:, lane].tolist()) for t in (a, b))
            require(F.from_limbs(got[:, lane].tolist())
                    == x * y * lf.rinv_int % lf.p_int,
                    f"mont_mul {lf.name}: lane {lane} != python ints")
        school = torch.zeros((32, B), dtype=torch.int64, device=dev)
        for i in range(16):
            school[i:i + 16] += a[i] * b
        mxu = mxu_range_cols(torch, lf, B, g, dev)
        redc_err = 0
        for name, cols in (("schoolbook", school), ("mxu range", mxu)):
            got_r = FK.mont_redc_cols(lf, cols)
            err = max_err(got_r, limb.redc_cols(lf, cols))
            require(err == 0, f"mont_redc {lf.name} {name}: kernel != plain")
            redc_err = max(redc_err, err)
        for lane in (0, B - 1, B // 5):
            v = sum(int(c) << (16 * k) for k, c in enumerate(
                mxu[:, lane].tolist()))
            require(lf.p_int << 256 <= v < 5 * lf.p_int ** 2
                    and max(mxu[:, lane].tolist()) < 1 << 31,
                    "mont_redc: an MXU-range lane out of its range")
            require(F.from_limbs(got_r[:, lane].tolist())
                    == v * lf.rinv_int % lf.p_int,
                    f"mont_redc {lf.name}: lane {lane} != python ints")
        res[lf.name] = {
            "mul_ms": cuda_ms(torch, lambda: FK.mont_mul(lf, a, b), reps=20),
            "mul_plain_ms": cuda_ms(torch, lambda: limb.mul(lf, a, b),
                                    reps=2),
            "redc_ms": cuda_ms(torch, lambda: FK.mont_redc_cols(lf, mxu),
                               reps=20),
            "redc_plain_ms": cuda_ms(torch, lambda: limb.redc_cols(lf, mxu),
                                     reps=2),
            "mul_max_abs_err": mul_err, "redc_max_abs_err": redc_err}
    mul_bms, mul_by = bound_ms(3 * 16 * 8 * B, B * MADS_PER_MUL)
    redc_bms, redc_by = bound_ms((32 + 16) * 8 * B, B * MADS_PER_REDC)
    emit("field", t0, B=B, mul_bound_ms=mul_bms, redc_bound_ms=redc_bms,
         **res)
    fq = res[limb.FQ.name]
    common = {"route": "cuda", "source": "reef_tpu_torch/csrc/mont.cu",
              "library_ms": None}
    return {
        "mont_mul": {
            "name": "mont_mul", **common,
            "replaces": "reef_tpu/ops/pallas_field.py:128",
            "max_abs_err": max(r["mul_max_abs_err"] for r in res.values()),
            "ms": fq["mul_ms"], "plain_ms": fq["mul_plain_ms"],
            "bound_ms": mul_bms, "bound_by": mul_by,
            "int_bound_ms": int_bound_ms(B * MADS_PER_MUL),
            "shape": f"(16, {B}) x (16, {B}) int64, Fq"},
        "mont_redc": {
            "name": "mont_redc", **common,
            "replaces": "reef_tpu/ops/pallas_field.py:184",
            "max_abs_err": max(r["redc_max_abs_err"] for r in res.values()),
            "ms": fq["redc_ms"], "plain_ms": fq["redc_plain_ms"],
            "bound_ms": redc_bms, "bound_by": redc_by,
            "int_bound_ms": int_bound_ms(B * MADS_PER_REDC),
            "shape": f"(32, {B}) -> (16, {B}) int64, Fq, values in "
                     f"[pR, 5p^2)"}}


@contextlib.contextmanager
def no_plain_products_on_card(phase: str):
    """Fail `phase` if a plain Montgomery product or REDC (limb.mul's and
    limb.redc_cols' body, `limb._redc_inplace`) ran on a CUDA tensor
    inside the block: with the field-kernel hook on, every one must be
    K3 or K4."""
    from reef_tpu_torch.ops import limb
    real, on_card = limb._redc_inplace, []

    def spy(f, cols, *args, **kw):
        if cols.is_cuda:
            on_card.append(tuple(cols.shape))
        return real(f, cols, *args, **kw)

    limb._redc_inplace = spy
    try:
        yield
    finally:
        limb._redc_inplace = real
    require(not on_card, f"{phase}: {len(on_card)} plain products on the "
            f"card (first batch {on_card[:1]})")


def phase_pippenger(torch, dev, rnd) -> None:
    """The v2 Pippenger MSM (ec/msm_pippenger.py, its products on K3)
    against the native host MSM, with K3's launches in each."""
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm_pippenger as mp
    from reef_tpu_torch.ec import native_msm
    from reef_tpu_torch.ec.msm import kernels_for
    from reef_tpu_torch.ec.pasta import PALLAS, VESTA
    from reef_tpu_torch.ops import limb
    from reef_tpu_torch.utils import cudabuild
    t0 = time.perf_counter()
    plain_mul = limb.mul
    res = {}
    for cv in (PALLAS, VESTA):
        n = PIPPENGER_N[cv.name]
        ck = kernels_for(cv)
        gens = PedersenGens(cv, b"chip_smoke/msm", n)
        scalars = [rnd.randrange(cv.order) for _ in range(n)]
        t1 = time.perf_counter()
        basis = mp.DeviceBasis(ck, gens.G, device=dev)
        upload_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        cudabuild.reset_counts()
        t1 = time.perf_counter()
        with no_plain_products_on_card(f"pippenger {cv.name}"):
            got = mp.msm_device(ck, scalars, basis)     # ends on the host
        secs = time.perf_counter() - t1
        launches = cudabuild.launch_counts()
        want = native_msm.msm_packed(cv, scalars, gens.packed_G(),
                                     handle=gens.native_basis())
        require(got == want, f"pippenger {cv.name}: device != native host")
        require(launches["mont_mul"] > 0, f"pippenger {cv.name}: K3 never "
                f"launched ({launches})")
        require(limb.mul is plain_mul, "pippenger: the field-kernel hook "
                "outlived msm_device")
        res[cv.name] = {"n": n, "s": secs, "pts_per_s": n / secs,
                        "basis_upload_s": upload_s,
                        "k3_launches": launches["mont_mul"]}
    emit("pippenger", t0, chunk=mp.chunk_cap(), **res)


def phase_mxu(torch, dev) -> None:
    """The MXU-formulated Poseidon under field_kernel.enabled(redc=True)
    against K5 on the same states, with K3's and K4's launches."""
    from reef_tpu_torch.models.prover_step import random_elems
    from reef_tpu_torch.ops import field_kernel as FK
    from reef_tpu_torch.ops import limb, poseidon_device, poseidon_mxu
    from reef_tpu_torch.utils import cudabuild
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(10)
    plain = limb.mul, limb.redc_cols

    def states(t, B):
        return random_elems((t, B), g, dev).permute(1, 0, 2).contiguous()

    def mxu(lf, X):
        with FK.enabled(redc=True), no_plain_products_on_card("mxu"):
            return poseidon_mxu.permute(lf, X)

    res = {}
    for B in MXU_B:
        lf = limb.FQ
        X = states(5, B)
        torch.cuda.synchronize()
        cudabuild.reset_counts()
        got = mxu(lf, X)
        torch.cuda.synchronize()
        launches = cudabuild.launch_counts()
        require(launches["mont_mul"] > 0 and launches["mont_redc"] > 0,
                f"mxu B={B}: K3 or K4 never launched ({launches})")
        err = max_err(got, poseidon_device.permute(lf, X))
        require(err == 0, f"mxu t=5 B={B}: != K5 (max {err})")
        ms = cuda_ms(torch, lambda: mxu(lf, X), reps=3)
        k5_ms = cuda_ms(torch, lambda: poseidon_device.permute(lf, X),
                        reps=3)
        res[f"t5_b{B}"] = {"ms": ms, "perms_per_s": B / ms * 1e3,
                           "k5_ms": k5_ms,
                           "k5_perms_per_s": B / k5_ms * 1e3,
                           "k3_launches": launches["mont_mul"],
                           "k4_launches": launches["mont_redc"]}
    for lf in (limb.FQ, limb.FP):
        for t in (9, 5):
            Y = states(t, MXU_T9_B)
            err = max_err(mxu(lf, Y), poseidon_device.permute(lf, Y))
            require(err == 0, f"mxu t={t} {lf.name}: != K5 (max {err})")
    require((limb.mul, limb.redc_cols) == plain,
            "mxu: the field-kernel hook outlived its block")
    emit("mxu", t0, t9_states=MXU_T9_B, **res)


def phase_msm_aux(torch, dev, rnd) -> None:
    """The binary msm_device and msm_pallas, both with their point adds
    on K1, against the native host MSM; both are off-path, and their K1
    launches (SPREAD ones too: the e2e makes none) are this phase's."""
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm, native_msm
    from reef_tpu_torch.ec.padd import msm_pallas
    from reef_tpu_torch.utils import cudabuild
    t0 = time.perf_counter()
    ck = msm.pallas_kernels()
    cv = ck.curve
    res, spread = {}, 0
    for name, n in (("binary", AUX_BINARY_N), ("pallas", AUX_PALLAS_N)):
        gens = PedersenGens(cv, b"chip_smoke/msm_aux", n)
        scalars = [rnd.randrange(cv.order) for _ in range(n)]
        torch.cuda.synchronize()
        cudabuild.reset_counts()
        t1 = time.perf_counter()
        if name == "binary":
            acc = msm.msm_device(ck, scalars, ck.to_plain(gens.G, dev))
            got = ck.plain_to_affine(acc[..., None])[0]
        else:
            got = ck.to_affine(msm_pallas(ck, scalars, gens.G, device=dev))
        secs = time.perf_counter() - t1
        k1 = cudabuild.launch_counts()["padd"]
        spread += cudabuild.launch_counts()["padd_spread"]
        want = native_msm.msm_packed(cv, scalars, gens.packed_G(),
                                     handle=gens.native_basis())
        require(got == want, f"msm_aux {name}: device != native host MSM")
        require(k1 > 0, f"msm_aux {name}: K1 never launched")
        res[name] = {"n": n, "s": secs, "k1_launches": k1}
    emit("msm_aux", t0, **res, k1_spread_launches=spread)


def dot_sums(sf, part) -> list:
    """The two cross dots of (2, 8, blocks) int32 partials, ints mod p."""
    from reef_tpu_torch.ops import limb
    words = part.cpu().permute(0, 2, 1).reshape(-1, limb.N32).numpy()
    ints = limb._words_to_ints(words, 32)
    nb = part.shape[2]
    return [sum(ints[k * nb:(k + 1) * nb]) % sf.p_int for k in (0, 1)]


def phase_ipa(torch, dev, rnd) -> dict:
    """The IPA round kernels against their plain versions on the card;
    returns their kernel-table rows (at Pallas 2^16, with Vesta 2^14's
    time beside)."""
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import ipa_device as D
    from reef_tpu_torch.ec.msm import kernels_for
    from reef_tpu_torch.ec.msm_v3 import msm_windows
    from reef_tpu_torch.ec.pasta import PALLAS, VESTA
    from reef_tpu_torch.utils import cudabuild
    t0 = time.perf_counter()
    curves = {"pallas": PALLAS, "vesta": VESTA}
    rows, res = {}, {}
    for cname, log in IPA_MAIN:
        cv = curves[cname]
        sf, ck = D.scalar_field(cv), kernels_for(cv)
        n_orig = 1 << log
        basis = PedersenGens(cv, b"reef/g/pv", n_orig).device_G()
        p = sf.p_int
        w, R, coeff = (D._table([rnd.randrange(p) for _ in range(n_orig)],
                                p, dev) for _ in range(3))
        launches = {k: cudabuild.launch_counts()[k] for k in IPA_KERNELS}
        errs = dict.fromkeys(IPA_KERNELS, 0)
        for n in (n_orig, IPA_MID_N, 2):
            sk = torch.zeros((basis.n2, 64), dtype=torch.uint8, device=dev)
            sp = torch.zeros_like(sk)
            D.scalars(sf, w, coeff, n, sk)
            D.scalars_plain(sf, w, coeff, n, sp)
            pk = D.dots(sf, w, R, n // 2)
            pp = D.dots_plain(sf, w, R, n // 2)
            torch.cuda.synchronize()
            errs["ipa_scalars"] = max(errs["ipa_scalars"],
                                      max_err(sk.int(), sp.int()))
            # the kernel's partials (one a block) and the plain one
            errs["ipa_dots"] = max(errs["ipa_dots"], int(
                dot_sums(sf, pk) != dot_sums(sf, pp)))
            if n != IPA_MID_N:
                accs = msm_windows(ck, basis, sk)
                got = D.combine(ck, sf, accs, D.ROWS, pk)
                want = D.combine_plain(ck, sf, accs, D.ROWS, pk)
                errs["ipa_combine"] = max(errs["ipa_combine"],
                                          max_err(got, want))
            x = rnd.randrange(1, p)
            xm, xim = sf.mont(x), sf.mont(pow(x, -1, p))
            wp, Rp, cp = w.clone(), R.clone(), coeff.clone()
            D.fold_plain(sf, wp, Rp, cp, n, xm, xim)
            D.fold(sf, w, R, coeff, n, xm, xim)
            torch.cuda.synchronize()
            errs["ipa_fold"] = max(errs["ipa_fold"], max_err(w, wp),
                                   max_err(R, Rp), max_err(coeff, cp))
        made = {k: cudabuild.launch_counts()[k] - launches[k]
                for k in IPA_KERNELS}
        require(all(v == 0 for v in errs.values()),
                f"ipa {cname} 2^{log}: kernel != plain: {errs}")
        require(made == {"ipa_scalars": 3, "ipa_dots": 3,
                         "ipa_combine": 2, "ipa_fold": 3},
                f"ipa {cname} 2^{log}: launches {made}")
        # each kernel at the first round, timed
        n, half = n_orig, n_orig // 2
        sk = torch.zeros((basis.n2, 64), dtype=torch.uint8, device=dev)
        D.scalars(sf, w, coeff, n, sk)
        pk = D.dots(sf, w, R, half)
        accs = msm_windows(ck, basis, sk)
        x = rnd.randrange(1, p)
        xm, xim = sf.mont(x), sf.mont(pow(x, -1, p))
        # (kernel, plain, multiplications, bytes: each input read once
        # and each output written once)
        runs = {
            "ipa_scalars": (lambda: D.scalars(sf, w, coeff, n, sk),
                            lambda: D.scalars_plain(sf, w, coeff, n, sk),
                            n, n * (32 + 32 + 64), f"({n}, 64) uint8"),
            "ipa_dots": (lambda: D.dots(sf, w, R, half),
                         lambda: D.dots_plain(sf, w, R, half),
                         2 * half, 2 * n * 32, f"half {half}"),
            "ipa_combine": (lambda: D.combine(ck, sf, accs, D.ROWS, pk),
                            lambda: D.combine_plain(ck, sf, accs, D.ROWS,
                                                    pk),
                            D.ROWS * 288 * MULS_PER_PADD,
                            64 * 96 + D.ROWS * 96,
                            "(3, 8, 64) window sums -> 2 rows"),
            "ipa_fold": (lambda: D.fold(sf, w, R, coeff, n, xm, xim),
                         lambda: D.fold_plain(sf, w, R, coeff, n, xm, xim),
                         4 * half + n, 4 * n * 32 + 2 * half * 32,
                         f"n {n}"),
        }
        for name, (kern, pl, muls, nbytes, shape) in runs.items():
            ms = device_ms(torch, kern)
            res[f"{name} {cname} 2^{log}"] = ms
            if cname != "pallas":
                rows[name][f"{cname}_2e{log}_ms"] = ms
                continue
            plain_ms = cuda_ms(torch, pl, reps=1)
            bms, by = bound_ms(nbytes, muls * MADS_PER_MUL)
            rows[name] = {
                "name": name, "route": "cuda",
                "source": "reef_tpu_torch/csrc/ipa.cu",
                "replaces": ("none: reef_tpu/native/msm.cpp ipa_cross "
                             "and ipa_fold (host C, no TPU kernel)"),
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "int_bound_ms": int_bound_ms(muls * MADS_PER_MUL),
                "shape": f"{shape}, {cname} 2^{log}"}
    emit("ipa", t0, device_ms=res)
    return rows


# csrc kernel function -> its rows of the kernel table (the rows "padd"
# and "poseidon" count every launch of K1 and K5, as their counters do)
KERNEL_ROWS = {"padd_kernel": ("padd",),
               "padd_spread_kernel": ("padd", "padd_spread"),
               "padd_reduce_kernel": ("padd", "padd_reduce"),
               "tree_level": ("msm_tree",),
               "perm_kernel": ("poseidon",),
               "perm_spread_kernel": ("poseidon",),
               "coeff_kernel": ("sumcheck_coeffs",),
               "fold_kernel": ("sumcheck_fold",),
               "eq_kernel": ("sumcheck_eq",),
               "mont_mul_kernel": ("mont_mul",),
               "mont_redc_kernel": ("mont_redc",),
               "ipa_scalars_kernel": ("ipa_scalars",),
               "ipa_dots_kernel": ("ipa_dots",),
               "ipa_combine_kernel": ("ipa_combine",),
               "ipa_fold_kernel": ("ipa_fold",)}


def e2e_profile(torch, prof):
    """Device milliseconds of one profiled e2e by kernel function (every
    kernel, copy and fill on the card), by kernel-table row, and the
    microseconds the card was busy in all."""
    import re
    by_fn = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"([A-Za-z_]\w*)\s*[<(]", ev.name)
        fn = m.group(1) if m else ev.name
        by_fn[fn] = by_fn.get(fn, 0.0) + ev.time_range.elapsed_us()
    per_e2e = {}
    for fn, us in by_fn.items():
        for row in KERNEL_ROWS.get(fn, ()):
            per_e2e[row] = per_e2e.get(row, 0.0) + us / 1e3
    busy = sum(by_fn.values())
    return ({k: v / 1e3 for k, v in sorted(by_fn.items(),
                                           key=lambda kv: -kv[1])},
            per_e2e, busy)


def build_all() -> None:
    """nvcc builds of the kernels (one process per source, all together)
    and g++ builds of the shared host libraries, then loads them."""
    from reef_tpu_torch.utils import cudabuild, nativebuild
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
    ptxas = {name: [ln.strip().replace("ptxas info    : ", "")
                    for ln in b["log"].splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Function properties for" in ln]
             for name, b in built.items()}
    emit("build", t0, nvcc_seconds={k: round(v["seconds"], 3)
                                    for k, v in built.items()},
         ptxas=ptxas)
    for name in cudabuild.LIBS:
        cudabuild.library(name)


def dna_argv(work: str, size: int) -> list:
    """`cli dna --e2e` on the dna.sh document of `size` bytes, written
    into `work`."""
    doc = os.path.join(work, "dna.txt")
    with open(doc, "w") as fh:
        fh.write(dna_text(size))
    return ["dna", "--e2e", "-d", doc, "-r",
            f"^.{{{size - len(DNA_MOTIF)}}}{DNA_MOTIF}.*", "-b", "0"]


def run_e2e(torch, work: str, argv: list, host: bool = False) -> float:
    """One in-process commit + prove + verify in `work`, which must
    verify, each operation on the route backend/routes.py chooses, or
    with `host` every one on the host; returns its wall seconds."""
    from reef_tpu_torch import cli
    from reef_tpu_torch.backend import routes
    prev_cwd = os.getcwd()
    out = io.StringIO()
    try:
        os.chdir(work)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                routes.use(routes.ALL_HOST if host else routes.policy()):
            cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        os.chdir(prev_cwd)
    require("Verification PASSED" in out.getvalue(),
            f"e2e (host={host}): proof did not verify:\n"
            + out.getvalue())
    return wall


@contextlib.contextmanager
def route_spies(exact: bool = False):
    """Record the device routes' calls inside an e2e: each msm_device_v3
    (curve, values, seconds, chunks) in `msms`, each device sumcheck
    (rounds, seconds) in `sumchecks`, each nlookup batch (tag, entries,
    route, seconds) in `nlookups`, each round of the device IPA engine
    (curve, length, basis chunks) in `ipa_rounds`.  With `exact`, the
    first device MSM of each (curve, values) and the first device
    sumcheck of each (tag, entries) keep their inputs and results:
    `rec.check()`, called after the e2e's wall has stopped, holds the MSM
    against the native host MSM on the same values and basis and the
    sumcheck against the host rounds on copies of its table, point and
    transcript state (either raises on a mismatch); the keys taken are in
    `exact_msms` and `exact_sumchecks`."""
    import types
    from reef_tpu_torch.backend import witness
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm_v3, native_msm
    from reef_tpu_torch.ec.ipa_device import IpaDevice
    from reef_tpu_torch.ops import sumcheck_device
    rec = types.SimpleNamespace(msms=[], sumchecks=[], nlookups=[],
                                exact_msms=[], exact_sumchecks=[],
                                ipa_rounds=[])
    pending = []                # (what, host function, its args, result)

    def check():
        while pending:
            what, host, args, got = pending.pop(0)
            require(host(*args) == got, what)

    rec.check = check
    orig_msm = msm_v3.msm_device_v3
    orig_sc = sumcheck_device.device_sumcheck_rounds
    orig_nl = witness.nlookup_prove
    orig_route = PedersenGens._msm_device_route
    orig_cross = IpaDevice.cross

    def ipa_round(self):
        out = orig_cross(self)
        rec.ipa_rounds.append((self.curve.name, self.n_orig,
                               self.basis.n_chunks))
        return out

    def timed(ck, scalars, points):
        t1 = time.perf_counter()
        out = orig_msm(ck, scalars, points)      # ends in a copy to the host
        rec.msms.append((ck.curve.name, len(scalars),
                         time.perf_counter() - t1, points.n_chunks))
        return out

    def timed_sc(lf, cache, *args):
        t1 = time.perf_counter()
        out = orig_sc(lf, cache, *args)          # ends in a copy to the host
        rec.sumchecks.append((cache.ell, time.perf_counter() - t1))
        return out

    def timed_nl(f, table, qs, vs, prev_q, prev_v, tag, doc_hash=None,
                 device_cache=None, host_cache=None):
        key = (tag, len(table))
        check = (exact and device_cache is not None
                 and key not in rec.exact_sumchecks)
        if check:
            rec.exact_sumchecks.append(key)
            copies = (f, list(table), list(qs), list(vs),
                      None if prev_q is None else list(prev_q), prev_v, tag,
                      doc_hash)
        t1 = time.perf_counter()
        out = orig_nl(f, table, qs, vs, prev_q, prev_v, tag, doc_hash,
                      device_cache=device_cache, host_cache=host_cache)
        rec.nlookups.append((tag, len(table),
                             "device" if device_cache else "host",
                             time.perf_counter() - t1))
        if check:
            pending.append((f"{tag} sumcheck of {len(table)} entries: "
                            "device != host rounds", orig_nl, copies,
                            copy.deepcopy(out)))
        return out

    def checked_route(self, values, on):
        out = orig_route(self, values, on)
        key = (self.cv.name, len(values))
        if exact and key not in rec.exact_msms:
            rec.exact_msms.append(key)
            pending.append((f"device MSM {key}: != native host MSM",
                            lambda gens, vals: native_msm.msm_packed(
                                gens.cv, vals, gens.packed_G(),
                                handle=gens.native_basis()),
                            (self, list(values)), out))
        return out

    try:
        msm_v3.msm_device_v3 = timed
        sumcheck_device.device_sumcheck_rounds = timed_sc
        witness.nlookup_prove = timed_nl
        PedersenGens._msm_device_route = checked_route
        IpaDevice.cross = ipa_round
        yield rec
    finally:
        msm_v3.msm_device_v3 = orig_msm
        sumcheck_device.device_sumcheck_rounds = orig_sc
        witness.nlookup_prove = orig_nl
        PedersenGens._msm_device_route = orig_route
        IpaDevice.cross = orig_cross


def run_serve(torch) -> dict:
    """`python -m reef_tpu_torch.workloads` with SERVE_ARGS (every workload
    through one `cli serve` worker on the card, the routes at their
    defaults) in a process of its own: it must exit 0 with every request
    verified.  Returns each request's wall (the first includes the
    worker's warm-up: kernel libraries, bases, caches)."""
    import re
    from reef_tpu_torch import workloads as W
    env = dict(os.environ, PYTHONPATH=W.ROOT)
    t1 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "reef_tpu_torch.workloads", *SERVE_ARGS],
        cwd=W.ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=SERVE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)          # the runner and its serve worker
        proc.communicate()
        raise RuntimeError(f"serve: no end in {SERVE_TIMEOUT_S} s")
    wall = time.perf_counter() - t1
    runs = [m.groups() for m in re.finditer(
        r"^(\w+)\s+doc=\s*(\d+)B\s+([\d.]+)s\s+(PASS|FAIL)$", out, re.M)]
    names = list(W.WORKLOADS) if SERVE_ARGS[0] == "all" else [SERVE_ARGS[0]]
    require(proc.returncode == 0 and [r[0] for r in runs] == names
            and all(r[3] == "PASS" for r in runs),
            f"serve: rc {proc.returncode}, runs {runs}:\n{out}\n"
            f"{err[-4000:]}")
    return {"process_wall_s": wall,
            "requests": {r[0]: {"doc_bytes": int(r[1]), "wall_s": float(r[2])}
                         for r in runs}}


def metrics_stages(path: str) -> dict:
    """The eight largest timers of a `--metrics` CSV in seconds (the
    prover's fold steps are `Prover/fold_step`).  The solver's timer
    overlaps the folds (two threads)."""
    import csv
    secs = {}
    with open(path, encoding="utf-8", newline="") as fh:
        for kind, comp, test, val, _ in csv.reader(fh):
            if kind == "time":
                key = f"{comp}/{test}"
                secs[key] = secs.get(key, 0.0) + int(val) / 1e6
    return dict(sorted(secs.items(), key=lambda kv: -kv[1])[:8])


def phase_workloads(torch) -> dict:
    """The JAX package's workload suite through the port's runner
    (reef_tpu_torch.workloads), in-process with the routes at their
    defaults (auto), then warm on the host and the card, then through one
    serve worker; returns the launches summed over the in-process pass."""
    from reef_tpu_torch import workloads as W
    from reef_tpu_torch.backend import routes
    from reef_tpu_torch.utils import cudabuild, nativebuild
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(dir=nativebuild.build_dir())
    total, per = {}, {}
    try:
        with route_spies(exact=True) as rec:
            for name, size in WORKLOAD_SIZES.items():
                n_msm, n_nl = len(rec.msms), len(rec.nlookups)
                csv_path = os.path.join(work, f"{name}.csv")
                argv = W.argv_for(name, size, work, metrics=csv_path)
                cudabuild.reset_counts()
                t1 = time.perf_counter()
                wall = run_e2e(torch, work, argv)
                launches = cudabuild.launch_counts()
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                nls = rec.nlookups[n_nl:]
                per[name] = {
                    "doc_bytes": os.path.getsize(argv[argv.index("-d") + 1]),
                    "wall_s": wall,
                    "device_msms": [(c, n, ch, s) for c, n, s, ch in
                                    rec.msms[n_msm:]],
                    "device_sumchecks": [(tag, n, s) for tag, n, route, s
                                         in nls if route == "device"],
                    "host_tables": sorted({(tag, n) for tag, n, route, _
                                           in nls if route == "host"}),
                    "nlookups": nls,
                    "launches": {k: v for k, v in launches.items() if v},
                    "stages_s": metrics_stages(csv_path)}
                emit("workload", t1, name=name,
                     **{k: v for k, v in per[name].items() if k != "nlookups"})
                rec.check()             # the exactness checks, off the wall
            # host against card, warm, on the two largest new shapes, in
            # pairs of alternating order
            warm = {}
            runs = (("host_routes", True), ("card", False))
            for name, pairs in WORKLOAD_WARM.items():
                warm[name] = {"order": [], "host_routes_wall_s": [],
                              "card_wall_s": [], "host_routes_stages_s": [],
                              "card_stages_s": []}
                for i in range(2 * pairs):
                    run, host = runs[(i + i // 2) % 2]
                    csv_path = os.path.join(work, f"{name}_{i}.csv")
                    argv = W.argv_for(name, WORKLOAD_SIZES[name], work,
                                      metrics=csv_path)
                    wall = run_e2e(torch, work, argv, host)
                    rec.check()
                    warm[name]["order"].append(run)
                    warm[name][f"{run}_wall_s"].append(wall)
                    warm[name][f"{run}_stages_s"].append(
                        metrics_stages(csv_path))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, n in WORKLOAD_MSM_N.items():
        require(any(m[1] == n for m in per[name]["device_msms"]),
                f"workload {name}: no device MSM of {n} values "
                f"({per[name]['device_msms']})")
    msm_keys = {(c, n) for p in per.values() for c, n, _, _ in
                p["device_msms"]}
    require(msm_keys <= set(rec.exact_msms),
            f"workloads: device MSMs {msm_keys} not all held against the "
            f"host ({rec.exact_msms})")
    # every lookup table runs where the auto floor sends it
    floor = routes.DEFAULT.sumcheck
    wrong = [(name, tag, n, route) for name, p in per.items()
             for tag, n, route, _ in p["nlookups"]
             if (route == "device") != (n >= floor)]
    require(not wrong, f"workloads: tables off their route (floor {floor}): "
            f"{wrong}")
    hybrid = {n for tag, n, _, _ in per[WORKLOAD_HYBRID]["nlookups"]
              if tag == "nlhybrid"}
    require(bool(hybrid), f"workload {WORKLOAD_HYBRID}: no hybrid table")
    on_card = sorted(("nlhybrid", n) for n in hybrid if n >= floor)
    require(set(on_card) <= set(rec.exact_sumchecks),
            f"workload {WORKLOAD_HYBRID}: hybrid tables {on_card} not held "
            f"against the host rounds ({rec.exact_sumchecks})")
    need = list(WORKLOAD_MSM_KERNELS)
    if any(p["device_sumchecks"] for p in per.values()):
        need += WORKLOAD_SUMCHECK_KERNELS
    require(all(total.get(k, 0) > 0 for k in need),
            f"workloads: a kernel never launched ({need}): {total}")
    serve = run_serve(torch)
    emit("workloads", t0, sizes=WORKLOAD_SIZES, launches=total,
         hybrid_tables=sorted(hybrid), sumcheck_floor=floor,
         exact_msms=sorted(rec.exact_msms),
         exact_sumchecks=sorted(rec.exact_sumchecks),
         walls_s={k: p["wall_s"] for k, p in per.items()},
         warm=warm, serve=serve)
    return total


def phase_options(torch) -> dict:
    """The CLI options no other phase proves (OPTIONS), each proved and
    verified in-process on the card with the routes at their defaults
    (auto), its launches counted from 0; the first device MSM and the
    first device sumcheck of each size held against the host after the
    walls.  Returns the launches summed over the phase."""
    from reef_tpu_torch.backend import routes
    from reef_tpu_torch.utils import cudabuild, nativebuild
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(dir=nativebuild.build_dir())
    total, per = {}, {}
    floor = routes.DEFAULT.sumcheck
    try:
        with route_spies(exact=True) as rec:
            for opt, (ab, flags, regex) in OPTIONS.items():
                if ab == "dna":
                    text = dna_text(OPTION_DNA_BYTES)
                else:
                    reps = OPTION_ASCII_BYTES // len(OPTION_TEXT)
                    text = OPTION_TEXT * reps
                doc = os.path.join(work, "option.txt")
                with open(doc, "w") as fh:
                    fh.write(text)
                argv = [ab, "--e2e", "-d", doc, "-r", regex(len(text)),
                        "-b", "0", *flags]
                n_msm, n_nl = len(rec.msms), len(rec.nlookups)
                cudabuild.reset_counts()
                wall = run_e2e(torch, work, argv)
                launches = cudabuild.launch_counts()
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                nls = rec.nlookups[n_nl:]
                wrong = [(tag, n, route) for tag, n, route, _ in nls
                         if (route == "device") != (n >= floor)]
                require(not wrong, f"options {opt}: tables off their route "
                        f"(floor {floor}): {wrong}")
                per[opt] = {"doc_bytes": len(text), "wall_s": wall,
                            "device_msms": [(c, n) for c, n, _, _ in
                                            rec.msms[n_msm:]],
                            "tables": [(tag, n, route) for tag, n, route, _
                                       in nls],
                            "launches": {k: v for k, v in launches.items()
                                         if v}}
            rec.check()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("options", t0, options=per, launches=total,
         exact_msms=sorted(rec.exact_msms),
         exact_sumchecks=sorted(rec.exact_sumchecks))
    return total


def int_leaves(obj, path=()):
    """(path, value) for every int leaf of a proof object: through its
    dataclasses, lists and tuples (bools excluded)."""
    if isinstance(obj, bool):
        return
    if isinstance(obj, int):
        yield path, obj
        return
    if isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from int_leaves(v, path + (i,))
        return
    for k, v in getattr(obj, "__dict__", {}).items():
        yield from int_leaves(v, path + (k,))


def with_leaf(root, path, fn):
    """A deep copy of `root` with the leaf at `path` replaced by
    fn(leaf); tuples on the way are rebuilt."""
    def rebuilt(obj, steps):
        if not steps:
            return fn(obj)
        step, rest = steps[0], steps[1:]
        if isinstance(obj, tuple):
            items = list(obj)
            items[step] = rebuilt(items[step], rest)
            return tuple(items)
        if isinstance(obj, list):
            obj[step] = rebuilt(obj[step], rest)
        else:
            setattr(obj, step, rebuilt(getattr(obj, step), rest))
        return obj
    return rebuilt(copy.deepcopy(root), list(path))


def phase_reject(torch, cmt_path: str, proof_path: str, argv: list) -> dict:
    """The e2e's own `.cmt`/`.proof` pair, made on the card, read back
    with serialize.load: it must verify untouched, and each of
    REJECT_LEAVES seeded int leaves plus one, and each of three hostile
    compressed points (an x off the curve, an x >= p, an unknown flag,
    each in a seeded point field of the IVC proof), must be refused by the
    port's verifier (False, or its VerifyError; any other exception fails
    the phase).  Returns the launches of the phase's verifications."""
    from reef_tpu_torch.backend import framework as FW
    from reef_tpu_torch.ec.pasta import PALLAS, VESTA
    from reef_tpu_torch.errors import VerifyError
    from reef_tpu_torch.frontend.safa import from_regex
    from reef_tpu_torch.utils import cudabuild, serialize
    t0 = time.perf_counter()
    commit = serialize.load(cmt_path, "cmt")
    proofs = serialize.load(proof_path, "proof")
    regex = argv[argv.index("-r") + 1]
    batch = int(argv[argv.index("-b") + 1])
    safa = from_regex("ACGT", regex)

    def verdict(p) -> bool:
        try:
            return FW.run_verifier(commit, safa, p, batch_size=batch)
        except VerifyError:
            return False

    cudabuild.reset_counts()
    t1 = time.perf_counter()
    require(verdict(proofs), "reject: the untouched e2e proof did not verify")
    honest_s = time.perf_counter() - t1
    rng = random.Random(REJECT_SEED)
    leaves = [pth for pth, _ in int_leaves(proofs)]
    require(len(leaves) > 200, f"reject: {len(leaves)} int leaves")
    forged = [("leaf", pth, with_leaf(proofs, pth, lambda v: v + 1))
              for pth in rng.sample(leaves, REJECT_LEAVES)]
    fields = ["U1_W", "U1_E", "U2_W", "U2_E", "u2_W", "T_last"]
    for kind in ("off the curve", "x >= p", "unknown flag"):
        field = rng.choice(fields)
        cv = PALLAS if field.startswith("U1") else VESTA
        x = 7                       # the first x with no y on the curve
        while (kind == "off the curve"
               and cv.sqrt((x ** 3 + 5) % cv.p) is not None):
            x += 1
        comp = {"off the curve": (x, 0), "x >= p": (cv.p + 1, 0),
                "unknown flag": (5, 7)}[kind]
        p2 = copy.deepcopy(proofs)
        setattr(p2.ivc, field, comp)
        forged.append((kind, (field,), p2))
    accepted, secs = [], []
    for kind, pth, p2 in forged:
        t1 = time.perf_counter()
        if verdict(p2):
            accepted.append((kind, pth))
        secs.append(time.perf_counter() - t1)
    launches = cudabuild.launch_counts()
    require(not accepted, f"reject: forged proofs verified: {accepted}")
    emit("reject", t0, leaves=len(leaves), forged=len(forged),
         mutated=[list(map(str, pth)) for kind, pth, _ in forged],
         honest_verify_s=honest_s, forged_verify_s=secs,
         launches={k: v for k, v in launches.items() if v})
    return launches


def phase_roles() -> dict:
    """The party roles, each in a process of its own on the card, through
    tools/card_pairs.py: the ROLES_CASES' commit, prove and verify, the
    resumed prover among them (killed at its first checkpoint, resumed in
    a new process, verified), each role timed and each prove process held
    to its launch floors; then the port's `--verify`, through one `cli
    serve` worker, over every pair of tests/data/card_pairs.json, made on
    the card and by the JAX package, each of which must pass.  Returns the
    launches summed over the phase's prove processes."""
    import importlib.util
    from reef_tpu_torch import workloads as W
    from reef_tpu_torch.utils import nativebuild
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "card_pairs", os.path.join(W.ROOT, "tools", "card_pairs.py"))
    CP = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CP)
    total, cases = {}, {}
    for rec in CP.make(list(ROLES_CASES), reference=False):
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
        cases[rec["name"]] = {k: rec.get(k) for k in (
            "seconds", "launches", "resume", "doc_bytes")}
    pairs = CP.load()["pairs"]
    makers = {p["made_by"] for p in pairs}
    require(makers == set(CP.MAKERS.values()),
            f"roles: {CP.OUT} holds pairs of {makers}")
    work = tempfile.mkdtemp(dir=nativebuild.build_dir())
    verified = {}
    worker = W.ServeWorker()
    try:
        for pair in pairs:
            key = f"{pair['made_by']}/{pair['name']}"
            d = os.path.join(work, key.replace("/", "_"))
            os.mkdir(d)
            argv = CP.verify_argv(pair, d)
            t1 = time.perf_counter()
            resp = worker.request(argv)
            secs = time.perf_counter() - t1
            require(bool(resp.get("ok"))
                    and "Verification PASSED" in resp.get("output", ""),
                    f"roles: the port's verifier refused {key}: {resp}")
            verified[key] = secs
    finally:
        worker.close()
        shutil.rmtree(work, ignore_errors=True)
    emit("roles", t0, cases=cases, pairs_verified=len(verified),
         verify_s=verified, launches=total)
    return total


def phase_card_tests() -> dict:
    """`python -m pytest --noconftest -p no:cacheprovider -m cuda
    tests/test_torch_card_*.py` in a process of its own (no JAX there):
    it must exit 0 with every collected test passed and none skipped.
    Returns the launches of its run (written by the `_torch_card_support`
    plugin)."""
    import glob
    import xml.etree.ElementTree as ET
    from reef_tpu_torch.utils import nativebuild
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(root, CARD_TESTS)))
    require(len(files) >= 5, f"card_tests: {files}")
    work = tempfile.mkdtemp(dir=nativebuild.build_dir())
    xml, counts = os.path.join(work, "junit.xml"), os.path.join(work, "n.json")
    env = dict(os.environ, REEF_CARD_COUNTS=counts,
               PYTHONPATH=os.pathsep.join([root, os.path.join(root, "tests")]))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-p",
             "no:cacheprovider", "-p", "_torch_card_support", "-m", "cuda",
             "-q", f"--junitxml={xml}",
             *[os.path.relpath(f, root) for f in files]],
            cwd=root, env=env, capture_output=True, text=True,
            timeout=CARD_TESTS_TIMEOUT_S)
        require(os.path.exists(xml), f"card_tests: no report, rc "
                f"{proc.returncode}:\n{proc.stdout[-4000:]}"
                f"\n{proc.stderr[-4000:]}")
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n = {k: int(suite.get(k)) for k in ("tests", "failures", "errors",
                                            "skipped")}
        with open(counts) as fh:
            launches = json.load(fh)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(proc.returncode == 0 and n["tests"] > 0
            and n["failures"] == n["errors"] == n["skipped"] == 0,
            f"card_tests: rc {proc.returncode}, {n}:\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    emit("card_tests", t0, files=[os.path.basename(f) for f in files],
         passed=n["tests"], launches={k: v for k, v in launches.items() if v},
         summary=proc.stdout.strip().splitlines()[-1])
    return launches


def main() -> int:
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm_v3, native_msm
    from reef_tpu_torch.ec.msm import pallas_kernels, vesta_kernels
    from reef_tpu_torch.ec.padd import padd_reduce_plain, padd_soa_plain
    from reef_tpu_torch.utils import cudabuild, device, nativebuild

    dev = device.select("cuda")
    rnd = random.Random(20261017)
    kernels = {}

    # ---- env -------------------------------------------------------------
    t0 = time.perf_counter()
    smi = nvidia_smi()
    SM_CLOCK_MHZ[0] = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    emit("env", t0, nvidia_smi=smi, sm_clock_max_mhz=SM_CLOCK_MHZ[0],
         torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- build -----------------------------------------------------------
    build_all()

    curves = [pallas_kernels(), vesta_kernels()]
    # the shapes the mesh phase and the mesh e2e add, held in the phases of
    # their kernels
    mesh_shapes = mesh_path_shapes(len(mesh_devices(torch)))

    # ---- padd (K1) -------------------------------------------------------
    kernels.update(phase_padd(torch, dev, curves, rnd, mesh_shapes))

    # ---- tree (K2) -------------------------------------------------------
    kernels["msm_tree"] = phase_tree(torch, dev, curves, mesh_shapes)

    # ---- msm -------------------------------------------------------------
    t0 = time.perf_counter()
    res = {}
    for ck in curves:
        cv = ck.curve
        PedersenGens(cv, b"chip_smoke/msm", max(MSM_NS))   # one derivation
        for n in MSM_NS:
            gens = PedersenGens(cv, b"chip_smoke/msm", n)
            scalars = [rnd.randrange(cv.order) for _ in range(n)]
            t1 = time.perf_counter()
            basis = msm_v3.DeviceBasisV3(ck, gens.G, device=dev)
            torch.cuda.synchronize()
            basis_s = time.perf_counter() - t1
            got = msm_v3.msm_device_v3(ck, scalars, basis)
            host = partial(native_msm.msm_packed, cv, scalars,
                           gens.packed_G(), handle=gens.native_basis())
            want = host()
            require(got == want, f"msm {cv.name} n={n}: device != native "
                    f"host MSM")
            scb = msm_v3.upload_scalars(basis, [scalars])[0]
            ms = cuda_ms(torch, lambda: msm_v3.msm_windows(ck, basis, scb),
                         reps=3)
            call_s, host_s = [], []
            for _ in range(2):
                t1 = time.perf_counter()
                msm_v3.msm_device_v3(ck, scalars, basis)
                call_s.append(time.perf_counter() - t1)
                t1 = time.perf_counter()
                host()
                host_s.append(time.perf_counter() - t1)
            res[f"{cv.name}_2e{n.bit_length() - 1}"] = {
                "n": n, "chunks": basis.n_chunks, "device_ms": ms,
                "pts_per_s": n / ms * 1e3, "call_s": call_s,
                "native_host_s": host_s, "basis_upload_s": basis_s}
    n = MSM_N
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
        msm_v3.tree_levels_plain, padd_reduce_plain), reps=1)
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
    emit("msm", t0, n=list(MSM_NS), chunk=msm_v3.DEFAULT_CAP, rows=R,
         row_n=nr,
         kernel_chunk_ms=kernel_chunk_ms,
         plain_chunk_ms_no_yardstick=plain_chunk_ms, **res)

    # ---- poseidon (K5), sumcheck (K6), merkle, step -----------------------
    kernels["poseidon"] = phase_poseidon(torch, dev, mesh_shapes)
    kernels.update(phase_sumcheck(torch, dev, rnd))
    phase_merkle(torch, dev)
    phase_step(torch, dev)

    # ---- field (K3, K4), pippenger, mxu, msm_aux --------------------------
    kernels.update(phase_field(torch, dev))
    phase_pippenger(torch, dev, rnd)
    phase_mxu(torch, dev)
    phase_msm_aux(torch, dev, rnd)

    # ---- ipa: the IPA round kernels ---------------------------------------
    kernels.update(phase_ipa(torch, dev, rnd))

    # ---- mesh: the multi-device prover ------------------------------------
    mesh_devs = phase_mesh(torch, dev, curves, rnd)

    # ---- e2e: the main path ----------------------------------------------
    t0 = time.perf_counter()
    from reef_tpu_torch.ops import sumcheck_device
    from reef_tpu_torch.parallel import mesh as PM

    work = tempfile.mkdtemp(dir=nativebuild.build_dir())
    size = DNA_BYTES
    argv = dna_argv(work, size)
    e2e = partial(run_e2e, torch, work, argv)

    mesh_calls = {"sharded_msm": 0, "sharded_rounds": 0}
    orig_mesh_msm = PM.sharded_msm
    orig_mesh_rounds = sumcheck_device.sharded_rounds

    def counted(name, fn, *a):
        # sharded_rounds over one shard is sumcheck_rounds
        mesh_calls[name] += name == "sharded_msm" or len(a[1]) > 1
        return fn(*a)

    def taken(rec):
        # the nlookup batches (entries, route, seconds) since the last call
        out = [(n, route, secs) for _, n, route, secs in rec.nlookups]
        rec.nlookups.clear()
        return out

    nl_runs = {}
    try:
        with route_spies() as rec:
            cudabuild.reset_counts()
            wall = e2e()
            launches = cudabuild.launch_counts()
            # the cold run's own .cmt/.proof pair, for phase reject
            kept = tempfile.mkdtemp(dir=nativebuild.build_dir())
            pair = {ext: shutil.copy(os.path.join(work, name), kept)
                    for name in os.listdir(work)
                    for ext in (".cmt", ".proof") if name.endswith(ext)}
            msms, sumchecks = list(rec.msms), list(rec.sumchecks)
            ipa_rounds = list(rec.ipa_rounds)
            nl_runs["cold"] = taken(rec)
            # the same run again, warm (generators, circuits and bases
            # cached in the process): both routes on the host, then on the
            # card
            host_wall = e2e(host=True)
            nl_runs["warm_host_routes"] = taken(rec)
            warm_wall = e2e()
            nl_runs["warm"] = taken(rec)
        # once more on the card, under the profiler: device time by kernel
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prof_wall = e2e()
        # and on the mesh of the mesh phase: every commit MSM through
        # sharded_msm, the document's sumcheck through sharded_rounds
        PM.select(mesh_devs)
        PM.sharded_msm = partial(counted, "sharded_msm", orig_mesh_msm)
        sumcheck_device.sharded_rounds = partial(counted, "sharded_rounds",
                                                 orig_mesh_rounds)
        cudabuild.reset_counts()
        mesh_wall = e2e()
        mesh_launches = cudabuild.launch_counts()
    finally:
        PM.sharded_msm = orig_mesh_msm
        sumcheck_device.sharded_rounds = orig_mesh_rounds
        PM.select(None)
        shutil.rmtree(work, ignore_errors=True)
    require(mesh_calls["sharded_msm"] > 0
            and mesh_calls["sharded_rounds"] > 0
            and all(mesh_launches[k] > 0 for k in E2E_KERNELS),
            f"e2e on the mesh: a sharded route or a kernel never ran: "
            f"{mesh_calls}, {mesh_launches}")
    require(all(launches[k] > 0 for k in E2E_KERNELS),
            f"e2e: a kernel of the main path never launched: {launches}")
    # the compressed SNARK's two proofs on the card: each IPA kernel once
    # a round
    require(sorted({(c, n) for c, n, _ in ipa_rounds}) ==
            sorted((c, 1 << log) for c, log in IPA_MAIN)
            and all(launches[k] == len(ipa_rounds) for k in IPA_KERNELS),
            f"e2e: device IPA rounds {len(ipa_rounds)} over "
            f"{sorted({(c, n) for c, n, _ in ipa_rounds})}, launches "
            f"{ {k: launches[k] for k in IPA_KERNELS} }")
    # K1 only in its reduces, one a chunk and one an MSM (the device IPA's
    # rounds: one MSM of both rows each); one coefficient launch a
    # sumcheck round
    reduces = sum(m[3] + 1 for m in msms) + sum(c + 1 for _, _, c in
                                                ipa_rounds)
    require(launches["padd_reduce"] == launches["padd"] == reduces,
            f"e2e: {launches['padd_reduce']} K1 reduces, {launches['padd']} "
            f"K1 launches, for {reduces} chunks and MSMs")
    require(launches["sumcheck_coeffs"] == sum(ell for ell, _ in sumchecks),
            f"e2e: {launches['sumcheck_coeffs']} coefficient launches for "
            f"the rounds of {sumchecks}")
    by_fn, per_e2e, busy_us = e2e_profile(torch, prof)
    method = "torch.profiler"
    if not by_fn:
        # no device activity traced: each of the two redesigned kernels'
        # launch shapes alone, times its launches
        method = "shape times x launches (no profiler trace)"
        shp = kernels["padd_reduce"]["shapes"]
        rounds = kernels["sumcheck_coeffs"]["round_ms"]
        k1 = (shp["fenwick"]["ms"] * (reduces - len(msms))
              + shp["digits"]["ms"] * len(msms))
        per_e2e = {"padd": k1, "padd_reduce": k1,
                   "sumcheck_coeffs": sum(sum(rounds[-ell:])
                                          for ell, _ in sumchecks)}
    # the document table: size + EOF + EPSILON entries, padded to 2^ell
    doc_ell = (size + 1).bit_length()
    require(doc_ell in [ell for ell, _ in sumchecks]
            and launches["poseidon_spread"] >= sum(ell for ell, _ in
                                                   sumchecks),
            f"e2e: the 2^{doc_ell} document sumcheck did not run on the "
            f"card ({sumchecks}, {launches})")
    emit("e2e", t0, doc_bytes=size, wall_s=wall, device_msms=len(msms),
         device_msm_sizes=[m[:2] for m in msms],
         per_e2e_method=method, profiled_wall_s=prof_wall,
         device_busy_ms=busy_us / 1e3,
         device_busy_share=busy_us / 1e6 / prof_wall,
         device_ms_by_function=by_fn,
         device_msm_s=sum(m[2] for m in msms),
         device_ipas=sorted({(c, n) for c, n, _ in ipa_rounds}),
         device_ipa_rounds=len(ipa_rounds),
         device_sumchecks=[s[0] for s in sumchecks],
         device_sumcheck_s=sum(s[1] for s in sumchecks),
         nlookup_prove_s=nl_runs, launches=launches,
         warm_wall_s=warm_wall, warm_host_routes_wall_s=host_wall,
         mesh_devices=mesh_devs, mesh_wall_s=mesh_wall,
         mesh_calls=mesh_calls, mesh_launches=mesh_launches)

    # ---- reject: the e2e's own proof, forged ------------------------------
    try:
        require(sorted(pair) == [".cmt", ".proof"],
                f"e2e: its .cmt/.proof pair is not in {work}: {pair}")
        reject = phase_reject(torch, pair[".cmt"], pair[".proof"], argv)
    finally:
        shutil.rmtree(kept, ignore_errors=True)

    # ---- options: the CLI options no other phase proves -------------------
    options = phase_options(torch)

    # ---- workloads: the JAX package's suite through the port's runner -----
    suite = phase_workloads(torch)

    # ---- roles: commit, prove and verify in processes of their own -------
    roles = phase_roles()

    # ---- card_tests: the cuda-marked tests, in a process without JAX -----
    card_tests = phase_card_tests()

    # every row's launches are the e2e's (K3 and K4, and K1's SPREAD add,
    # run off its path: their phases' lines give their launches there);
    # the workload suite's in-process pass beside them
    for name, k in kernels.items():
        k["launches"] = launches[name]
        k["suite_launches"] = suite.get(name, 0)
        k["options_launches"] = options.get(name, 0)
        k["reject_launches"] = reject.get(name, 0)
        k["roles_launches"] = roles.get(name, 0)
        k["card_tests_launches"] = card_tests.get(name, 0)
        k["per_e2e_ms"] = per_e2e.get(name)
    kernels["poseidon"]["spread_launches"] = launches["poseidon_spread"]
    # the bound at the card's integer rate, beside the kernel table
    int_bounds = {name: k.pop("int_bound_ms") for name, k in kernels.items()}
    for shape, v in kernels["padd_reduce"]["shapes"].items():
        int_bounds[f"padd_reduce {shape}"] = v.pop("int_bound_ms")
    table = [{**{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "per_e2e_ms", "shape")},
        **k} for k in kernels.values()]
    print(json.dumps({"total_seconds": round(time.perf_counter() - t_all,
                                             3)}), flush=True)
    print(json.dumps({"int_bound_ms": int_bounds,
                      "sm_clock_max_mhz": SM_CLOCK_MHZ[0]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
