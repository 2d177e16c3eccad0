"""Run one cell of the benchmark of reef_tpu_torch once.

    python3 reefbench/run.py --workload dna_1mb.fresh --seed 7 \
        --seconds 45 --trace 0

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`configs/<name>.json`) and a traffic mix (`traffic/<name>.json`).  The
run's process is a warm proving worker on the cell's CUDA cards: set-up
(the process start, the kernel libraries, the warm-up cycles, a shared
document's commitment), then a closed loop of commit, prove and verify
requests for `--seconds`, then the check of what the window produced
against the plain reference (`reference/`).  The last line of standard
output is one JSON object; with `--trace 0` it holds the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics from a
profiled window.  Without the CUDA cards the cell asks for it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True
    ).stdout.strip().splitlines()[0]


def role_means(done, field: str) -> dict:
    """Each role's mean a request of the dict `field` of its records."""
    out = {}
    for role in ("commit", "prove", "verify"):
        recs = [r for r in done if r["role"] == role]
        keys = sorted({k for r in recs for k in r[field]})
        if recs:
            out[role] = {" ".join(k) if isinstance(k, tuple) else k:
                         sum(r[field].get(k, 0) for r in recs) / len(recs)
                         for k in keys}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="reefbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, REPO]
    from harness import guard, loop, manifest
    from harness.trace import summarize

    res = loop.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace))
    import torch
    cell, man, done = res["cell"], res["manifest"], res["done"]
    chips = cell["chips"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["peak"]}
    info = {"card": nvidia_smi("name,power.limit,clocks.max.sm"),
            "cycles": len({id(r["cycle"]) for r in done}),
            "window_s": res["window_s"], "build_s": res["build_s"],
            "walls": {role: [r["wall"] for r in done if r["role"] == role]
                      for role in loop.ROLES},
            "launches_per_request": role_means(done, "launches")}
    metrics = {}
    breakdown = None
    if args.trace:
        clock = float(nvidia_smi("clocks.max.sm").split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        summary = summarize(res["tracer"], list(range(chips)),
                            manifest.work_counts(), sms, clock)
        device["busy_s"], device["window_s"] = (summary["busy_s"],
                                                summary["window_s"])
        breakdown = summary["breakdown"]
        info.update(kernel_s=summary["kernel_s"], bound_s=summary["bound_s"],
                    measured_s=summary["measured_s"],
                    stages=role_means(done, "stages"))
        run = loop.Run(done, summary)
        for m in manifest.metrics_of(man, "per_layer", cell["name"]):
            value = manifest.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = loop.end_to_end(res)
        for m in manifest.metrics_of(man, "end_to_end", cell["name"]):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    res["tracer"] = None

    t_check = time.perf_counter()
    checks, correct = loop.judge(res)
    info["check_s"] = time.perf_counter() - t_check
    failed = sum(not r["ok"] for r in done)
    bad = guard.loaded_forbidden()
    bad_ref = guard.reference_imports(os.path.join(BENCH, "reference"))
    if bad or bad_ref:
        print(f"forbidden modules loaded: {bad}; reference imports: "
              f"{bad_ref}", file=sys.stderr)
        return 3
    print(json.dumps({"info": info}), flush=True)
    out = {"correct": correct, "attempted": len(done), "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": limit}
                     for k, (v, limit) in checks.items()}
    for k, (v, limit) in checks.items():
        print(f"check {k} {v} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
