"""One run of one cell: the warm proving worker, its set-up, the closed
loop over the window, and the numbers it reports.

The run's process is the worker.  Each request is `reef_tpu_torch.cli
.main(argv)`, what `cli serve` does for each line it reads, so the torch
import, the kernel libraries, the bases and the automaton and circuit
caches live across requests as they do in a proving service.  One
client: each request starts when the one before it has returned, and a
cycle started inside the window is finished and counted.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import manifest
from .traffic import Cycle, Traffic

ROLES = ("commit", "prove", "verify")


def process_start() -> float:
    """The epoch time at which this process started (/proc)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as fh:
        btime = next(int(ln.split()[1]) for ln in fh
                     if ln.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


class Run:
    """What the per-layer readers read: the window's requests, each with
    its stage timers, counters and route seconds, and the device
    summary."""

    def __init__(self, requests: List[dict], device: dict):
        self.requests, self.device = requests, device

    def _mean(self, role: str, values):
        """Mean a request of `role`, None where no request has a value."""
        vals = [values(r) for r in self.requests if r["role"] == role]
        if all(v is None for v in vals):
            return None
        return sum(v or 0.0 for v in vals) / len(vals)

    def stage_mean(self, role: str, component: str, test: str):
        return self._mean(role, lambda r: r["stages"].get((component, test)))

    def route_mean(self, role: str, route: str):
        return self._mean(role, lambda r: r["routes"].get(route))

    def count_mean(self, role: str, component: str, name: str):
        """A counter's events, mean a request of `role`."""
        return self._mean(role, lambda r: r["stages"].get(
            ("count", component, name)))


class Worker:
    """The requests of one run, in one directory of artifacts."""

    def __init__(self, config: dict, traffic: Traffic, work: str,
                 device: str, tracer=None,
                 doc_filter: Optional[Callable[[Cycle, bytes], bytes]] = None):
        import torch
        from reef_tpu_torch import cli
        from reef_tpu_torch.utils import cudabuild
        self.torch, self.cli, self.cudabuild = torch, cli, cudabuild
        self.config, self.traffic, self.work = config, traffic, work
        self.device, self.tracer = device, tracer
        self.doc_filter = doc_filter
        self.shared_cmt: Optional[bytes] = None

    def _paths(self, cyc: Cycle):
        tag = "shared" if not self.traffic.mix["new_doc"] \
            else f"c{cyc.index + 1}"
        base = os.path.join(self.work, tag)
        return (base + ".txt", base + ".cmt",
                os.path.join(self.work, f"q{cyc.index + 1}.proof"))

    def argv(self, role: str, cyc: Cycle, stages: Optional[str]) -> list:
        doc, cmt, proof = self._paths(cyc)
        argv = [self.config["alphabet"], f"--{role}", "-d", doc,
                "--cmt-name", cmt]
        if role == "commit":
            argv += ["--seed", str(cyc.commit_seed)]
        else:
            argv += ["-r", cyc.regex, "-b", str(self.config["batch_size"]),
                     *self.config["flags"], "--proof-name", proof]
        if self.device != "cuda":
            argv += ["--device", self.device]
        if stages:
            argv += ["--metrics", stages]
        return argv

    def write_doc(self, cyc: Cycle) -> None:
        doc = self.traffic.document(cyc.doc_key)
        if self.doc_filter is not None:
            doc = self.doc_filter(cyc, doc)
        with open(self._paths(cyc)[0], "wb") as fh:
            fh.write(doc)

    def request(self, role: str, cyc: Cycle) -> dict:
        stages = (os.path.join(self.work, "stages.csv")
                  if self.tracer is not None else None)
        argv = self.argv(role, cyc, stages)
        before = self.cudabuild.launch_counts()
        out, err = io.StringIO(), ""
        ok = False
        ctx = (self.tracer.request(role) if self.tracer is not None
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            try:
                with contextlib.redirect_stdout(out):
                    self.cli.main(argv)
                ok = True
            except SystemExit as e:
                ok = e.code in (None, 0)
                err = f"exit {e.code}"
            except Exception as e:          # a request that raised: failed
                err = f"{type(e).__name__}: {e}"
            if self.device == "cuda":
                self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = out.getvalue()
        rec = {"role": role, "cycle": cyc, "wall": wall, "ok": ok,
               "error": err, "verdict": None}
        if role == "verify":
            rec["verdict"] = ("Verification PASSED" in text or (
                False if "Verification FAILED" in text else None))
            rec["ok"] = rec["verdict"] is not None
        after = self.cudabuild.launch_counts()
        rec["launches"] = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        if self.tracer is not None:
            rec["routes"] = dict(self.tracer.routes)
            rec["stages"] = (read_stages_once(stages) if os.path.exists(stages)
                             else {})
        return rec

    def cycle(self, cyc: Cycle) -> List[dict]:
        """The cycle's requests; its artifacts are read into the records
        (for the check after the window) and deleted."""
        if self.traffic.mix["new_doc"]:
            self.write_doc(cyc)
        recs = [self.request(role, cyc) for role in cyc.roles]
        doc, cmt, proof = self._paths(cyc)
        cmt_bytes = _read(cmt) if self.traffic.mix["new_doc"] \
            else self.shared_cmt
        for r in recs:
            r["cmt"] = cmt_bytes
            if r["role"] == "prove":
                r["proof"] = _read(proof)
        for path in ((doc, cmt, cmt + "key", proof)
                     if self.traffic.mix["new_doc"] else (proof,)):
            if os.path.exists(path):
                os.remove(path)
        return recs

    def setup_commit(self) -> List[dict]:
        cyc = self.traffic.setup_commit()
        self.write_doc(cyc)
        rec = self.request("commit", cyc)
        self.shared_cmt = rec["cmt"] = _read(self._paths(cyc)[1])
        return [rec]


def read_stages_once(path: str) -> Dict:
    from .trace import read_stages
    try:
        return read_stages(path)
    finally:
        os.remove(path)


def _read(path: str) -> Optional[bytes]:
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return fh.read()


def load_kernels(torch, chips: int) -> float:
    """Load every kernel library and host library (built into the port's
    build directory by the first run of a checkout); on a host with more
    cards than the cell's, put the process mesh (by default every card)
    on the cell's.  Returns the seconds the builds and loads took."""
    from reef_tpu_torch.ec import native_msm
    from reef_tpu_torch.frontend import native_solver
    from reef_tpu_torch.ops import native_fieldvec
    from reef_tpu_torch.parallel import mesh
    from reef_tpu_torch.utils import cudabuild
    t0 = time.perf_counter()
    cudabuild.build()
    for host_lib in (native_msm, native_solver, native_fieldvec):
        host_lib._load()
    build_s = time.perf_counter() - t0
    for name in cudabuild.LIBS:
        cudabuild.library(name)
    if torch.cuda.device_count() > chips:
        mesh.select([f"cuda:{i}" for i in range(chips)])
    return build_s


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", repo: str = manifest.REPO,
             bench: str = manifest.BENCH, doc_filter=None) -> dict:
    """One run: set-up, then the window; returns its records, set-up's
    and the window's, with what the report and the check need."""
    t_start = process_start()
    man = manifest.load_manifest(repo)
    cell = manifest.cell(man, cell_name)
    config = manifest.config(cell["config"], bench)
    mix = manifest.traffic(cell["traffic"], bench)
    import torch
    build_s = 0.0
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{cell_name} needs {cell['chips']} CUDA "
                             f"device(s); torch sees "
                             f"{torch.cuda.device_count()}")
        build_s = load_kernels(torch, cell["chips"])
    traffic = Traffic(config, mix, seed)
    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer(torch)
        tracer.install()
    work = tempfile.mkdtemp(prefix="reefbench-")
    try:
        worker = Worker(config, traffic, work, device, tracer, doc_filter)
        setup_recs = worker.setup_commit() if not mix["new_doc"] else []
        warm = []
        for cyc in traffic.warmup():
            warm += worker.cycle(cyc)
        if not all(r["ok"] for r in setup_recs + warm):
            bad = next(r for r in setup_recs + warm if not r["ok"])
            raise RuntimeError(f"set-up {bad['role']} failed: "
                               f"{bad['error']}")
        if device == "cuda":
            torch.cuda.synchronize()
            for d in range(cell["chips"]):
                torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.time() - t_start
        if tracer is not None:
            tracer.start()
        done: List[dict] = []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            done += worker.cycle(traffic.cycle(i))
            i += 1
        window_s = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()
            tracer.uninstall()
        peak = (max(torch.cuda.max_memory_allocated(d)
                    for d in range(cell["chips"]))
                if device == "cuda" else 0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"cell": cell, "config": config, "traffic": traffic,
            "setup": setup_recs, "done": done, "setup_s": setup_s,
            "build_s": build_s,
            "window_s": window_s, "tracer": tracer, "peak": peak,
            "manifest": man, "seed": seed}


def end_to_end(res: dict) -> Dict[str, float]:
    """Each role's mean wall over the window's requests of it."""
    out = {"setup_s": res["setup_s"]}
    for role in ROLES:
        walls = [r["wall"] for r in res["done"] if r["role"] == role]
        if walls:
            out[f"{role}_s"] = sum(walls) / len(walls)
    return out


def judge(res: dict) -> Tuple[dict, bool]:
    """The checks of the run's requests, set-up's included, and whether
    they pass; the reference is imported only now, after the window."""
    from . import check
    checks = check.judge_run(res["config"], res["traffic"],
                             res["setup"] + res["done"], res["seed"])
    return checks, check.is_correct(checks)
