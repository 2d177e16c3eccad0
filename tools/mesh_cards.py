#!/usr/bin/env python3
"""Run the multi-device prover with one shard a card, on every CUDA card
of a node.

    python3 tools/mesh_cards.py      # on a node with two cards or more

Builds the kernels, holds K1 against its plain version at the shapes this
mesh adds (chip_smoke.py's `padd` phase with `mesh_path_shapes`), then
runs chip_smoke.py's `mesh` phase on a mesh of every CUDA device torch
sees (the sharded MSMs, the sharded 2^20 sumcheck and the sharded
flagship step, each exact against its single-device counterpart on
cuda:0 and the host, then dryrun_multichip), and the 1 MB DNA e2e: cold
with cuda:0 alone as the process mesh, then warm E2E_PAIRS times each,
alternating cuda:0 alone and every card as the process mesh (each run's
wall and the host seconds of its device MSMs and device sumchecks); on
the mesh it must prove and verify through sharded_msm and the sharded
sumcheck rounds with K1, K2, K5 and K6 launched.  Prints one JSON line
per phase, then each card's name and power limit, then
{"ok": true, "cards": N}.  Exits non-zero, printing no result, where
torch sees fewer than two CUDA devices.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

E2E_PAIRS = 3          # warm e2e runs on cuda:0 alone and on the mesh, each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("mesh_cards: torch sees fewer than two CUDA devices",
              file=sys.stderr)
        return 2
    import chip_smoke as CS
    from reef_tpu_torch.backend import commitment as CM
    from reef_tpu_torch.ec.msm import pallas_kernels, vesta_kernels
    from reef_tpu_torch.ops import poseidon_kernel, sumcheck_device
    from reef_tpu_torch.parallel import mesh as PM
    from reef_tpu_torch.utils import cudabuild, device, nativebuild

    dev = device.select("cuda")
    CS.build_all()
    curves = [pallas_kernels(), vesta_kernels()]
    rnd = random.Random(20261017)
    CS.phase_padd(torch, dev, curves, rnd,
                  CS.mesh_path_shapes(torch.cuda.device_count()))
    mesh_devs = CS.phase_mesh(torch, dev, curves, rnd)

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(dir=nativebuild.build_dir())
    e2e = partial(CS.run_e2e, torch, work, CS.dna_argv(work, CS.DNA_BYTES))
    calls = {"sharded_msm": 0, "sharded_rounds": 0}
    route_s = {"msm": 0.0, "sumcheck": 0.0}
    orig_msm, orig_rounds = PM.sharded_msm, sumcheck_device.sharded_rounds
    orig_route = CM.PedersenGens._msm_device_route
    orig_sc = sumcheck_device.device_sumcheck_rounds

    def counted(name, fn, *a):
        # sharded_rounds over one shard is sumcheck_rounds
        calls[name] += name == "sharded_msm" or len(a[1]) > 1
        return fn(*a)

    def timed(name, fn, *a):
        t1 = time.perf_counter()
        out = fn(*a)                       # ends in a copy to the host
        route_s[name] += time.perf_counter() - t1
        return out

    # warm runs alternating cuda:0 alone and the mesh, in one process;
    # each run's wall and the host seconds of its device MSMs and device
    # sumchecks
    walls = {"single": [], "mesh": []}
    routes = {"single": [], "mesh": []}
    try:
        PM.sharded_msm = partial(counted, "sharded_msm", orig_msm)
        sumcheck_device.sharded_rounds = partial(counted, "sharded_rounds",
                                                 orig_rounds)
        CM.PedersenGens._msm_device_route = (
            lambda gens, values: timed("msm", orig_route, gens, values))
        sumcheck_device.device_sumcheck_rounds = partial(timed, "sumcheck",
                                                         orig_sc)
        PM.select(["cuda:0"])
        cold_wall = e2e("1", "auto")
        for _ in range(E2E_PAIRS):
            for name, devs in (("single", ["cuda:0"]), ("mesh", mesh_devs)):
                PM.select(devs)
                route_s.update(msm=0.0, sumcheck=0.0)
                cudabuild.reset_counts()
                walls[name].append(e2e("1", "auto"))
                routes[name].append(dict(route_s))
                if name == "mesh":
                    launches = cudabuild.launch_counts()
    finally:
        PM.sharded_msm = orig_msm
        sumcheck_device.sharded_rounds = orig_rounds
        CM.PedersenGens._msm_device_route = orig_route
        sumcheck_device.device_sumcheck_rounds = orig_sc
        PM.select(None)
        shutil.rmtree(work, ignore_errors=True)
    CS.require(calls["sharded_msm"] > 0 and calls["sharded_rounds"] > 0
               and all(launches[k] > 0 for k in CS.E2E_KERNELS),
               f"e2e on the cards: a sharded route or a kernel never ran: "
               f"{calls}, {launches}")
    consts = sorted({str(d) for d, _, _ in poseidon_kernel._CONSTS_SET})
    CS.require(consts == sorted(set(mesh_devs)),
               f"K5's constants set on {consts}, not on every card")
    CS.emit("e2e_cards", t0, devices=mesh_devs, cold_wall_s=cold_wall,
            single_card_wall_s=walls["single"], mesh_wall_s=walls["mesh"],
            single_card_route_s=routes["single"], mesh_route_s=routes["mesh"],
            mesh_calls=calls, mesh_launches=launches,
            poseidon_consts_on=consts)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    print(json.dumps({"ok": True, "cards": torch.cuda.device_count()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
