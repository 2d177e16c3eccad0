"""The benchmark workloads of the reference's tests/scripts/*.sh (dna.sh,
password.sh, pihole.sh, email_dkim.sh, zombie.sh), driven through the
port's CLI.

Each workload makes a synthetic document of the same character and runs
`cli <alphabet> --e2e` on it (commit, prove, verify), one process a run or
every run through one long-lived `cli serve` worker:

    python -m reef_tpu_torch.workloads dna --size 10000
    python -m reef_tpu_torch.workloads password
    python -m reef_tpu_torch.workloads dkim --size 1024
    python -m reef_tpu_torch.workloads all --serve
    python -m reef_tpu_torch.workloads all --device cpu   # no card

`--device` (default cuda) passes through to the CLI.  The table, the
documents and the regexes are those of the JAX package's
`workloads/run.py`; a test holds them equal.  Documents are written as
UTF-8 bytes (the utf8 workloads hold CJK and emoji).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_UNI_CACHE: dict = {}


def _uni_doc(n: int, tail: str) -> str:
    """Deterministic multi-script (latin/accents/CJK/emoji) document of
    ~n BYTES ending in `tail` (offsets in the regexes are CODEPOINTS)."""
    key = (n, tail)
    if key not in _UNI_CACHE:
        unit = "naïve café — 世界🌍: ab "
        reps = max(1, (n - 32) // len(unit.encode()))
        _UNI_CACHE[key] = unit * reps + tail
    return _UNI_CACHE[key]


WORKLOADS = {
    # name: alphabet, regex function (of the document's length in
    # codepoints), document function (of the size and a seeded rng), flags
    "dna": {
        "alphabet": "dna",
        "regex": lambda n: f"^.{{{n - 24}}}ATGGGCTACAGAAACCGTGCCAAA.*",
        "doc": lambda n, rng: "".join(rng.choice("ACGT")
                                      for _ in range(n - 24))
        + "ATGGGCTACAGAAACCGTGCCAAA",
        "flags": [],
    },
    "password": {
        "alphabet": "ascii",
        "regex": lambda n: "^(?=.*[A-Z].*[A-Z])(?=.*[a-z]).{12}$",
        "doc": lambda n, rng: "xKwP3q9ZtmBv"[:12],
        "flags": [],
    },
    "pihole": {
        "alphabet": "ascii",
        "regex": lambda n: r"^(.+[_.-])?telemetry[_.-]",
        "doc": lambda n, rng: "app.telemetry.example.com/path?q=1",
        "flags": [],
    },
    "dkim": {
        "alphabet": "ascii",
        "regex": lambda n: "dkim-signature: v=1; a=rsa-sha256.*",
        "doc": lambda n, rng: ("x-header: " + "a" * max(0, n - 60)
                               + "\ndkim-signature: v=1; a=rsa-sha256; stuff"),
        "flags": [],
    },
    "zombie_date": {
        "alphabet": "ascii",
        "regex": lambda n: r"[0-9][0-9]/[0-9][0-9]/[0-9][0-9]",
        "doc": lambda n, rng: "a" * max(0, n - 10) + " 12/25/23 x",
        "flags": [],
    },
    # BASELINE.json config 4: projections + hybrid nlookup on a long doc
    "proj_hybrid": {
        "alphabet": "ascii",
        "regex": lambda n: f"^.{{{max(0, n - 16)}}}needleinhaystack.*",
        "doc": lambda n, rng: "h" * max(0, n - 16) + "needleinhaystack",
        "flags": ["-p", "-y"],
    },
    # full unicode: CJK and accented codepoints, range-class edges
    "unicode": {
        "alphabet": "utf8",
        "regex": lambda n: "café.*世界",
        "doc": lambda n, rng: ("naïve " * max(1, n // 12))[:max(0, n - 12)]
        + "café — 世界",
        "flags": [],
    },
    # BASELINE.json config 5 at scale: utf8 --merkle --negate on a
    # multi-script doc; the anchored regex names a motif at a fixed
    # codepoint offset that the document does not hold
    "unicode_mn": {
        "alphabet": "utf8",
        "regex": lambda n: f"^.{{{n - 6}}}禁🛑MARK.*",
        "doc": lambda n, rng: _uni_doc(n, "终端OK"),
        "flags": ["-m", "-n"],
    },
    # utf8 projections + hybrid: the motif at the end of a multi-script doc
    "unicode_proj": {
        "alphabet": "utf8",
        "regex": lambda n: f"^.{{{n - 5}}}世界END.*",
        "doc": lambda n, rng: _uni_doc(n, "世界END"),
        "flags": ["-p", "-y"],
    },
    # BASELINE.json config 5: merkle commitment + negated non-match proof
    "merkle_negate": {
        "alphabet": "ascii",
        "regex": lambda n: f"^.{{{max(0, n - 24)}}}FORBIDDEN-MARKER-XYZQ.*",
        "doc": lambda n, rng: "".join(rng.choice("abcdefgh")
                                      for _ in range(n)),
        "flags": ["-m", "-n"],
    },
}


def case(name: str, size: int) -> Tuple[str, str, bytes, List[str]]:
    """(alphabet, regex, document bytes, flags) of one workload at `size`
    (seed 42)."""
    spec = WORKLOADS[name]
    doc = spec["doc"](size, random.Random(42))
    return (spec["alphabet"], spec["regex"](len(doc)), doc.encode("utf-8"),
            list(spec["flags"]))


def argv_for(name: str, size: int, work: str, batch: int = 0,
             device: str = "cuda", metrics: Optional[str] = None
             ) -> List[str]:
    """Write the workload's document into `work` and return the CLI's
    `--e2e` arguments for it, its artifacts pinned into `work`."""
    ab, regex, doc, flags = case(name, size)
    doc_path = os.path.join(work, f"{name}.txt")
    with open(doc_path, "wb") as fh:
        fh.write(doc)
    argv = [ab, "--e2e", "-d", doc_path, "-r", regex, "-b", str(batch),
            *flags, "--device", device,
            "--cmt-name", os.path.join(work, f"{name}.cmt"),
            "--proof-name", os.path.join(work, f"{name}.proof")]
    if metrics:
        argv += ["--metrics", metrics]
    return argv


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=ROOT)


class ServeWorker:
    """One long-lived `reef_tpu_torch.cli serve` proving worker (JSON
    lines): the deployment shape of a proving service, one process that
    keeps the torch import, the kernel builds, device bases and the
    generator and circuit caches across every proof."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "reef_tpu_torch.cli", "serve"],
            env=_env(), cwd=ROOT, text=True, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        ready = self.proc.stdout.readline()
        assert ready and json.loads(ready).get("ready"), ready

    def request(self, argv: List[str]) -> dict:
        self.proc.stdin.write(json.dumps({"argv": argv}) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            return {"ok": False, "output": "",
                    "error": f"worker exited {self.proc.poll()}"}
        return json.loads(line)

    def close(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except Exception:
            self.proc.kill()
            self.proc.wait()


def run_one(name: str, size: int, batch: int = 0,
            metrics: Optional[str] = None,
            worker: Optional[ServeWorker] = None, device: str = "cuda"
            ) -> Tuple[bool, float, int]:
    """One workload's commit + prove + verify in a temporary directory, in
    a CLI process of its own or through `worker`; prints one line and
    returns (verified, wall seconds, document bytes)."""
    with tempfile.TemporaryDirectory() as d:
        argv = argv_for(name, size, d, batch, device, metrics)
        n_bytes = os.path.getsize(os.path.join(d, f"{name}.txt"))
        t0 = time.time()
        if worker is not None:
            resp = worker.request(argv)
            dt = time.time() - t0
            ok = bool(resp.get("ok")) and \
                "Verification PASSED" in resp["output"]
            err = resp.get("error", "") + resp.get("output", "")[-2000:]
        else:
            r = subprocess.run(
                [sys.executable, "-m", "reef_tpu_torch.cli"] + argv, cwd=d,
                env=_env(), capture_output=True, text=True)
            dt = time.time() - t0
            ok = "Verification PASSED" in r.stdout
            err = f"{r.stdout}\n{r.stderr[-2000:]}"
    print(f"{name:13s} doc={n_bytes:>8}B  {dt:8.3f}s  "
          f"{'PASS' if ok else 'FAIL'}" + ("" if ok else f"\n{err}"),
          flush=True)
    return ok, dt, n_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="reef_tpu_torch.workloads")
    ap.add_argument("workload", choices=list(WORKLOADS) + ["all"])
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("-b", "--batch", type=int, default=0)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--serve", action="store_true",
                    help="route all runs through ONE long-lived serve-mode "
                         "worker (warm path; amortizes per-process costs)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the CLI's engine device")
    args = ap.parse_args(argv)
    names = list(WORKLOADS) if args.workload == "all" else [args.workload]
    worker = ServeWorker() if args.serve else None
    fails = 0
    try:
        for name in names:
            ok, _, _ = run_one(name, args.size, args.batch, args.metrics,
                               worker=worker, device=args.device)
            fails += not ok
    finally:
        if worker is not None:
            worker.close()
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
