"""A dry run of the multi-device prover on real data.

The port of the JAX package's `__graft_entry__.dryrun_multichip`:

  1. the sharded nlookup sumcheck on the transition table of a real SAFA
     (`.*b` over `aaaaaaaab`, batch 2), whose Fiat-Shamir transcript must
     equal the host route's;
  2. the sharded MSM on real curve points against the native host MSM;
  3. commit + prove + verify of a document with both sharded routes
     forced (backend/routes.py: every sumcheck table and, on the CPU,
     the device routes too) on the mesh as the process mesh, the
     compressed SNARK's IPAs on the mesh's round engine
     (ec/ipa_device.py `IpaMesh`): the proof must verify, and the
     commit MSMs that ran on `sharded_msm` and the sumchecks that ran on
     `sharded_rounds` over more than one shard are counted (both must be
     more than 0).

    python -m reef_tpu_torch.parallel.dryrun                  # the card(s)
    python -m reef_tpu_torch.parallel.dryrun cuda:0 cuda:0    # two shards
    python -m reef_tpu_torch.parallel.dryrun cpu cpu cpu cpu  # on the CPU

With no arguments it runs on every CUDA device where torch sees more than
one, else on eight shards of cuda:0, and raises where torch sees no CUDA
device; the CPU runs only where the arguments name it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import sys
import time
from typing import Dict, List, Optional, Sequence
from unittest import mock

# step 3's document: 31 characters, so that its document table of 32
# entries splits over a mesh of up to 16 devices
E2E_DOC = "a" * 30 + "b"


def default_devices() -> List[str]:
    """Every CUDA device where torch sees more than one, else eight shards
    on cuda:0 (the mesh of the JAX package's MULTICHIP_r05.json); raises
    where torch sees no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name the mesh's devices, "
                           "e.g. cpu cpu")
    n = torch.cuda.device_count()
    return ([f"cuda:{i}" for i in range(n)] if n > 1
            else ["cuda:0"] * 8)


def dryrun_multichip(devices: Sequence, msm_n: int = 64,
                     e2e_mesh_commits: Optional[int] = None,
                     log=print) -> Dict[str, object]:
    """Run the three steps on a mesh over `devices`; raises on any
    mismatch or failed verification.  Step 2 takes msm_n points a device;
    step 3 routes every commit MSM that takes the device route to the
    sharded MSM and every IPA to the mesh's round engine, or with
    `e2e_mesh_commits` only that many commits, the later ones to the host
    MSM and every IPA to the host engine (on the CPU a shard's plain
    point adds take seconds).  Returns what each step counted and its
    seconds."""
    from ..backend import commitment as CM
    from ..backend import framework as FW
    from ..backend import routes
    from ..backend import sumcheck as SC
    from ..backend.table import TransitionTable, doc_transform
    from ..ec.msm import pallas_kernels
    from ..ec.native_msm import msm_packed
    from ..frontend.safa import from_regex
    from ..ops import field as F
    from ..ops import sumcheck_device as SD
    from ..ops.limb import FQ as LFQ
    from . import mesh as PM

    t0 = time.perf_counter()
    mesh = PM.make_mesh(devices=devices)
    m = mesh.size
    f = F.FQ
    out: Dict[str, object] = {"devices": [str(d) for d in mesh.devices]}

    def lap(step: str, msg: str) -> None:
        out[f"{step}_s"] = time.perf_counter() - t0
        log(f"dryrun +{out[f'{step}_s']:7.2f}s  {step}: {msg}")

    # 1. a real table, real lookups: the sharded transcript = the host's
    safa = from_regex("ab", ".*b")
    codes = [ord(c) for c in "aaaaaaaab"]
    udoc = doc_transform(safa.ab, codes)
    table = TransitionTable(safa, udoc, len(udoc), len(codes),
                            batch_size=2).table
    rng = random.Random(4)
    qs = [rng.randrange(len(table)) for _ in range(4)]
    vs = [table[q] for q in qs]
    ell = max(1, (len(table) - 1).bit_length())
    prev_q = [rng.randrange(f.p) for _ in range(ell)]
    prev_v = SC.verifier_mle_eval(f, table, prev_q)
    host = SC.nlookup_prove(f, table, qs, vs, prev_q, prev_v, "nl")
    cache = (PM.sharded_table_cache(LFQ, table, mesh)
             if not m & (m - 1) and m <= 1 << ell
             else PM.table_cache(LFQ, table, mesh))
    dev = SC.nlookup_prove(f, table, qs, vs, prev_q, prev_v, "nl",
                           device_cache=cache)
    if dev != host:
        raise RuntimeError("dryrun: the sharded sumcheck's transcript "
                           "differs from the host route's")
    out["sumcheck_table"] = len(table)
    out["sumcheck_sharded"] = len(cache.t_shards) > 1
    lap("step1", f"sumcheck on a {len(table)}-entry table "
        f"({'sharded' if out['sumcheck_sharded'] else 'on the lead'}) "
        "equals the host route")

    # 2. the sharded MSM on real points against the native host MSM
    ck = pallas_kernels()
    n = msm_n * m
    gens = CM.PedersenGens(ck.curve, b"dryrun/msm", n)
    scalars = [rng.randrange(ck.curve.order) for _ in range(n)]
    basis = PM.ShardedBasis(ck, gens.G, mesh)
    got = PM.sharded_msm(mesh, ck, scalars, basis)
    want = msm_packed(ck.curve, scalars, gens.packed_G(),
                      handle=gens.native_basis())
    if got != want:
        raise RuntimeError("dryrun: the sharded MSM differs from the "
                           "native host MSM")
    out["msm_n"] = n
    lap("step2", f"sharded MSM of {n} points equals the native host MSM")

    # 3. commit + prove + verify with both sharded routes forced
    counts = {"sharded_msm": 0, "sharded_rounds": 0}
    orig_msm, orig_rounds = PM.sharded_msm, SD.sharded_rounds
    forced = routes.Policy(sumcheck=1, cpu=True)
    if e2e_mesh_commits is not None:
        forced = dataclasses.replace(forced, ipa=None)

    def msm_counted(*a, **kw):
        counts["sharded_msm"] += 1
        if counts["sharded_msm"] == e2e_mesh_commits:
            # the later commits to the host, until the proof is done
            stack.enter_context(routes.use(
                dataclasses.replace(forced, msm=None)))
        return orig_msm(*a, **kw)

    def rounds_counted(lf, t_shards, *a):
        counts["sharded_rounds"] += len(t_shards) > 1
        return orig_rounds(lf, t_shards, *a)

    prev_mesh = PM._PROCESS_MESH
    codes = [ord(c) for c in E2E_DOC]
    try:
        PM.select(mesh)
        with contextlib.ExitStack() as stack:
            stack.enter_context(routes.use(forced))
            stack.enter_context(mock.patch.object(PM, "sharded_msm",
                                                  msm_counted))
            stack.enter_context(mock.patch.object(SD, "sharded_rounds",
                                                  rounds_counted))
            commit, dc = FW.run_committer(codes, safa.ab, False, seed=7)
            proofs = FW.run_prover(commit, dc, safa, codes, batch_size=2)
            lap("step3", f"proved ({counts['sharded_msm']} sharded MSMs, "
                f"{counts['sharded_rounds']} sharded sumchecks)")
            ok = FW.run_verifier(commit, safa, proofs, batch_size=2)
    finally:
        PM.select(prev_mesh)
    if not ok:
        raise RuntimeError("dryrun: the mesh-proved e2e did not verify")
    if not all(counts.values()):
        raise RuntimeError(f"dryrun: a sharded route never ran: {counts}")
    out.update(counts)
    lap("step3", "verified")
    return out


if __name__ == "__main__":
    from ..utils import device
    args = sys.argv[1:] or default_devices()
    device.select(args[0].split(":")[0])
    dryrun_multichip(args)
