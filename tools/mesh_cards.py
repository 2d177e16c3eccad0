#!/usr/bin/env python3
"""Run the multi-device prover with one shard a card, on every CUDA card
of a node.

    python3 tools/mesh_cards.py      # on a node with two cards or more
    python3 tools/mesh_cards.py --ipa-only cuda:0 cuda:0 cuda:0 cuda:0

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
sumcheck rounds with K1, K2, K5 and K6 launched.  Then the phase
`ipa_mesh`: at the e2e's sizes (Pallas 2^16, Vesta 2^14) a whole
`ipa_prove` on the mesh engine (ec/ipa_device.py `IpaMesh` over the
sharded basis) must equal the host engine's, every L, R and the final
scalar, blinds seeded alike; and a round's milliseconds (cross and fold,
to the end of their work; medians over IPA_REPS IPAs) on the mesh engine
and on `IpaDevice` on the lead (cuda:0) alone, with the mesh engine's
`Mesh` spans a round.  Prints one JSON line per phase, then each card's name and power
limit, then {"ok": true, "cards": N}.  Exits non-zero, printing no
result, where torch sees fewer than two CUDA devices.

`--ipa-only DEV ...` runs the phase `ipa_mesh` alone on a mesh of the
devices named (repeats allowed: cuda:0 four times holds four shards on
one card).
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
IPA_REPS = 3           # timed IPAs an engine, after one untimed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _round_ms(torch, eng, xs, mt) -> float:
    """Milliseconds a round of the engine, to the end of its work; its
    spans into `mt`."""
    from reef_tpu_torch.utils import metrics
    for s in eng.streams:
        s.synchronize()
    t0 = time.perf_counter()
    with metrics.recording(mt):
        for x in xs:
            eng.cross()
            eng.fold(x)
    for s in eng.streams:
        s.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / len(xs)
    eng.final()
    eng.close()
    return ms


def phase_ipa_mesh(torch, mesh_devs) -> dict:
    """The mesh engine against the host engine, byte for byte, and a
    round on each device engine (module docstring)."""
    import statistics
    import chip_smoke as CS
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import ipa_sweep
    from reef_tpu_torch.backend import commitment as CM
    from reef_tpu_torch.backend import ipa, routes
    from reef_tpu_torch.ec import ipa_device
    from reef_tpu_torch.ec.pasta import PALLAS, VESTA
    from reef_tpu_torch.parallel import mesh as PM
    from reef_tpu_torch.utils import metrics
    t0 = time.perf_counter()
    mesh = PM.make_mesh(devices=mesh_devs)
    single = PM.make_mesh(devices=mesh_devs[:1])
    out = {}
    try:
        for cname, log in CS.IPA_MAIN:
            cv = {"pallas": PALLAS, "vesta": VESTA}[cname]
            n, p = 1 << log, cv.order
            rng = random.Random(20261018 + log)
            gens = CM.PedersenGens(cv, b"reef/g/pv", n)
            G_s = CM.shared_scalar_gens(cv).G[0]
            w = [rng.randrange(p) for _ in range(n)]
            R = [rng.randrange(p) for _ in range(n)]
            rho, r_v = rng.randrange(p), rng.randrange(p)
            v = sum(a * b for a, b in zip(w, R)) % p
            with routes.use(routes.ALL_HOST):
                C_w = gens.commit(w, rho)
                C_v = cv.add(cv.mul(v, G_s), cv.mul(r_v, gens.H))
                inputs = (G_s, w, rho, R, v, r_v, C_w, C_v)
                _, host = ipa_sweep.prove(CM, ipa, gens, inputs, 1)
            PM.select(mesh)
            mt = metrics.Metrics()
            with metrics.recording(mt):
                _, on_mesh = ipa_sweep.prove(CM, ipa, gens, inputs, 1)
            took = {k[1]: c for k, c in mt.events.items() if k[0] == "IPA"}
            CS.require(took == {"mesh": 1},
                       f"ipa_mesh: {cname} took the engines {took}")
            CS.require(on_mesh == host,
                       f"ipa_mesh: the mesh engine's proof differs from "
                       f"the host engine's at {cname} 2^{log}")
            with routes.use(routes.ALL_HOST):
                CS.require(ipa.ipa_verify(gens, G_s, R, C_w, C_v, on_mesh,
                                          CM.Transcript(b"sweep")),
                           f"ipa_mesh: no verify at {cname} 2^{log}")
            xs = [rng.randrange(1, p) for _ in range(log)]
            times = {"mesh": [], "lead": []}
            spans = []
            for _ in range(IPA_REPS + 1):
                for name in times:
                    PM.select(mesh if name == "mesh" else single)
                    eng = (ipa_device.IpaMesh(gens, w, R, mesh)
                           if name == "mesh"
                           else ipa_device.IpaDevice(gens, w, R))
                    mt = metrics.Metrics()
                    times[name].append(_round_ms(torch, eng, xs, mt))
                    if name == "mesh":
                        spans.append({k[1]: 1e3 * s / log
                                      for k, s in mt.timers.items()
                                      if k[0] == "Mesh"})
            out[cname] = {
                "log_n": log, "proof_equal": True,
                "rounds": len(on_mesh.Ls),
                "mesh_round_ms": statistics.median(times["mesh"][1:]),
                "lead_round_ms": statistics.median(times["lead"][1:]),
                "mesh_runs_ms": times["mesh"][1:],
                "lead_runs_ms": times["lead"][1:],
                "mesh_span_ms_a_round": spans[-1]}
    finally:
        PM.select(None)
    CS.emit("ipa_mesh", t0, devices=list(mesh_devs), **out)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch
    if argv[:1] == ["--ipa-only"]:
        import chip_smoke as CS
        from reef_tpu_torch.utils import device
        device.select("cuda")
        CS.build_all()
        phase_ipa_mesh(torch, argv[1:])
        print(json.dumps({"ok": True, "cards": torch.cuda.device_count()}),
              flush=True)
        return 0
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
            lambda gens, values, on: timed("msm", orig_route, gens, values,
                                           on))
        sumcheck_device.device_sumcheck_rounds = partial(timed, "sumcheck",
                                                         orig_sc)
        PM.select(["cuda:0"])
        cold_wall = e2e()
        for _ in range(E2E_PAIRS):
            for name, devs in (("single", ["cuda:0"]), ("mesh", mesh_devs)):
                PM.select(devs)
                route_s.update(msm=0.0, sumcheck=0.0)
                cudabuild.reset_counts()
                walls[name].append(e2e())
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
    phase_ipa_mesh(torch, mesh_devs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    print(json.dumps({"ok": True, "cards": torch.cuda.device_count()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
