#!/usr/bin/env python3
"""Make `.cmt`/`.proof` pairs with the party roles in processes of their
own, and keep them as test data.

    python3 tools/card_pairs.py --rev <commit>              # on the card
    python3 tools/card_pairs.py --rev <commit> --reference  # JAX, CPU

For each case of CASES the document is written into a scratch directory,
then `python -m reef_tpu_torch.cli <alphabet> --commit`, `--prove` and
`--verify` run there, each in a process of its own, on the CLI's default
`--device cuda`, each operation on the route backend/routes.py chooses.
The prove process runs through this file's `role` runner, which calls
`cli.main` and then writes the process's kernel launch counts
(`cudabuild.launch_counts`) into a file; it also writes the counts so far
next to each checkpoint, just before the checkpoint is saved.  A case is refused, and the run
fails, when a role fails, when the verifier does not print `Verification
PASSED`, or when the prove process launched K2 (`msm_tree`) or K1's reduce
(`padd_reduce`) no time; in a case marked `table` (a lookup table of at
least 2^14 entries, which the sumcheck floor sends to the card) also K5's
block-per-state launch (`poseidon_spread`) or K6 (`sumcheck_coeffs`).

The case `resume` is the crashed prover.  Its first prove process runs
with `--checkpoint` and is killed (SIGKILL) as soon as the checkpoint file
appears; `serialize.save` writes it atomically, so the file is whole.  A
second prove process must resume from it (`resuming from checkpoint: N
folds done`, N >= RESUME_MIN_FOLDS), finish and remove it, and the
verifier must accept its proof; the launch floors hold for the second
process, and the floors of K2 and K1's reduce also for the first up to
its checkpoint (the counts written next to it), so the folds the
checkpoint holds committed on the card.  A first process that ends
before it is killed is a failure.

The output is one JSON file (default tests/data/card_pairs.json): for each
case the alphabet, regex, flags and each role's argv (file names relative
to the directory the roles ran in), the `.cmt` and the `.proof` as base64
with their sha256, the prove process's launch counts and each role's
seconds; and the maker: the card's name and power limit (`nvidia-smi`),
torch and CUDA, and the commit given with --rev (40 hex digits, then
optionally what the tree held beyond it).  The prover's secret `.cmtkey`
is never kept.  Every run makes the whole table of its maker and replaces
that maker's pairs; the other maker's pairs in the file are kept.

With --reference the roles run through the JAX package's CLI (`python -m
reef_tpu.cli`, JAX on the CPU, host routes) over REFERENCE_CASES, and the
pairs are stored marked `made_by: "reef_tpu"` beside the card's
(`"reef_tpu_torch"`).  Without --reference the tool refuses to run where
torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIS = os.path.abspath(__file__)
OUT = os.path.join(ROOT, "tests", "data", "card_pairs.json")
sys.path.insert(0, ROOT)

# the launch floors of every prove process on the card, and of the cases
# whose lookup table runs there
MSM_KERNELS = ("msm_tree", "padd_reduce")
TABLE_KERNELS = ("poseidon_spread", "sumcheck_coeffs")
CHECKPOINT_EVERY = 4
RESUME_MIN_FOLDS = 4
ROLE_TIMEOUT_S = 600
# the prove process's launch counts so far, written next to each
# checkpoint just before it is saved
AT_CHECKPOINT = ".launches.json"
REV = re.compile(r"[0-9a-f]{40}")

# name: the document (a workload of reef_tpu_torch.workloads at a size, or
# its own text, alphabet and regex), the batch (`-b`, default 0), extra
# flags, and whether a table of at least 2^14 entries runs on the card
CASES = {
    "password": {"workload": "password", "size": 0},
    # the main path: dna.sh's 1 MB document (the same bytes and regex as
    # chip_smoke.py's `dna_argv`), its 2^20-entry document table
    "dna": {"workload": "dna", "size": 1_000_000, "table": True},
    # its 2^14-entry hybrid table
    "proj_hybrid": {"workload": "proj_hybrid", "size": 102400,
                    "table": True},
    # the host Merkle tree is built twice a proof (commit, pub_setup)
    "merkle_negate": {"workload": "merkle_negate", "size": 4096},
    "unicode": {"workload": "unicode", "size": 1000},
    "case_insensitive": {"alphabet": "ascii",
                         "text": "Hello World, hello REEF reef",
                         "regex": "^hello world.*reef$",
                         "flags": ["--case-insensitive"]},
    # thirteen folds of two characters: a checkpoint every four
    "resume": {"alphabet": "ascii", "text": "hello reef, " * 8,
               "regex": "^hello reef, .*hello reef, $", "batch": 2,
               "resume": True},
}
# what the JAX package proves on the CPU, each well under a minute
REFERENCE_CASES = {
    "password": {"workload": "password", "size": 0},
    "unicode": {"workload": "unicode", "size": 256},
    "proj_hybrid": {"workload": "proj_hybrid", "size": 2048},
    "merkle_negate": {"workload": "merkle_negate", "size": 2048},
}
MAKERS = {False: "reef_tpu_torch", True: "reef_tpu"}


class CaseRefused(RuntimeError):
    """A role failed, the proof did not verify, the prover did not resume,
    or a kernel of the floors never launched."""


def case_inputs(spec: dict):
    """(alphabet, regex, document bytes, flags, batch) of a case."""
    if "workload" in spec:
        from reef_tpu_torch import workloads
        ab, regex, doc, flags = workloads.case(spec["workload"], spec["size"])
    else:
        ab, regex, doc = spec["alphabet"], spec["regex"], \
            spec["text"].encode("utf-8")
        flags = []
    return (ab, regex, doc, flags + list(spec.get("flags", [])),
            spec.get("batch", 0))


def role_argvs(name: str, spec: dict, device: Optional[str] = None) -> dict:
    """Each role's CLI arguments, its files named relative to the
    directory the roles run in."""
    ab, regex, _, flags, batch = case_inputs(spec)
    common = ["-d", f"{name}.txt", "-r", regex, "-b", str(batch), *flags,
              "--cmt-name", f"{name}.cmt", "--proof-name", f"{name}.proof"]
    if device:
        common += ["--device", device]
    argv = {role: [ab, f"--{role}", *common]
            for role in ("commit", "prove", "verify")}
    if spec.get("resume"):
        argv["prove"] += ["--checkpoint", f"{name}.ckpt",
                          "--checkpoint-every", str(CHECKPOINT_EVERY)]
    return argv


def refusals(spec: dict, rec: dict) -> List[str]:
    """The kernels of the case's floors that its prove process launched no
    time; in a resumed case also K2 and K1's reduce that the killed
    process launched no time before its checkpoint."""
    need = MSM_KERNELS + (TABLE_KERNELS if spec.get("table") else ())
    bad = [k for k in need if not rec["launches"].get(k)]
    if spec.get("resume"):
        bad += [f"{k} before the checkpoint" for k in MSM_KERNELS
                if not rec["resume"]["launches"].get(k)]
    return bad


def role_env(reference: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
    if reference:
        env.update(REEF_DEVICE_MSM="0", REEF_DEVICE_SUMCHECK="0",
                   JAX_PLATFORMS="cpu")
    return env


def role_cmd(role: str, argv: List[str], counts: str,
             reference: bool) -> List[str]:
    if reference:
        return [sys.executable, "-m", "reef_tpu.cli", *argv]
    if role == "prove":
        return [sys.executable, THIS, "role", counts, *argv]
    return [sys.executable, "-m", "reef_tpu_torch.cli", *argv]


def run_role(cmd: List[str], work: str, env: dict, what: str):
    """One role's process to its end; (stdout, seconds).  Raises
    CaseRefused where it fails."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                           text=True, timeout=ROLE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise CaseRefused(f"{what}: no end in {ROLE_TIMEOUT_S} s") from None
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise CaseRefused(f"{what}: exit code {r.returncode}\n"
                          f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return r.stdout, secs


def killed_at_checkpoint(cmd: List[str], work: str, env: dict, ckpt: str,
                         what: str) -> dict:
    """Start the prove process and SIGKILL it as soon as `ckpt` appears;
    its launch counts up to the checkpoint are those written next to it.
    Raises CaseRefused where it ends first or the file never appears."""
    path = os.path.join(work, ckpt)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=work, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        while proc.poll() is None and not os.path.exists(path):
            if time.perf_counter() - t0 > ROLE_TIMEOUT_S:
                raise CaseRefused(f"{what}: no checkpoint in "
                                  f"{ROLE_TIMEOUT_S} s")
            time.sleep(0.005)
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        out, err = proc.communicate()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    secs = time.perf_counter() - t0
    if proc.returncode != -signal.SIGKILL or not os.path.exists(path):
        raise CaseRefused(f"{what}: ended (exit code {proc.returncode}) "
                          f"before it was killed at its checkpoint\n"
                          f"{out[-4000:]}\n{err[-4000:]}")
    with open(path + AT_CHECKPOINT) as fh:
        launches = {k: v for k, v in json.load(fh).items() if v}
    return {"killed_after_s": secs, "exit_code": proc.returncode,
            "checkpoint_bytes": os.path.getsize(path), "launches": launches}


def run_case(name: str, work: str, reference: bool = False,
             device: Optional[str] = None) -> dict:
    """The case's roles, each a process of its own in `work`; its record
    (see the module's docstring).  `device` passes `--device` to the
    port's CLI (the default is the CLI's own, cuda).  Raises CaseRefused
    where a role fails, the proof does not verify or the prover does not
    resume; the launch floors are `refusals`'."""
    spec = (REFERENCE_CASES if reference else CASES)[name]
    ab, regex, doc, flags, batch = case_inputs(spec)
    with open(os.path.join(work, f"{name}.txt"), "wb") as fh:
        fh.write(doc)
    argv = role_argvs(name, spec, device)
    env = role_env(reference)
    counts = os.path.join(work, f"{name}.launches.json")
    cmd = {role: role_cmd(role, a, counts, reference)
           for role, a in argv.items()}
    rec = {"name": name, "made_by": MAKERS[reference], "alphabet": ab,
           "regex": regex, "flags": flags, "batch": batch,
           "doc_bytes": len(doc),
           "doc_sha256": hashlib.sha256(doc).hexdigest(),
           "table": bool(spec.get("table")), "argv": argv, "seconds": {}}
    if "workload" in spec:
        rec["workload"] = {"name": spec["workload"], "size": spec["size"]}
    secs = rec["seconds"]
    _, secs["commit"] = run_role(cmd["commit"], work, env, f"{name} commit")
    if spec.get("resume"):
        rec["resume"] = killed_at_checkpoint(cmd["prove"], work, env,
                                             f"{name}.ckpt",
                                             f"{name} first prove")
    out, secs["prove"] = run_role(cmd["prove"], work, env, f"{name} prove")
    if spec.get("resume"):
        m = re.search(r"resuming from checkpoint: (\d+) folds done", out)
        if not m or int(m.group(1)) < RESUME_MIN_FOLDS:
            raise CaseRefused(f"{name}: the second prove process did not "
                              f"resume after {RESUME_MIN_FOLDS} folds:\n"
                              f"{out[-4000:]}")
        if os.path.exists(os.path.join(work, f"{name}.ckpt")):
            raise CaseRefused(f"{name}: the checkpoint outlived the proof")
        rec["resume"]["folds_done"] = int(m.group(1))
    out, secs["verify"] = run_role(cmd["verify"], work, env,
                                   f"{name} verify")
    if "Verification PASSED" not in out:
        raise CaseRefused(f"{name}: the proof did not verify:\n{out}")
    if not reference:
        with open(counts) as fh:
            rec["launches"] = {k: v for k, v in json.load(fh).items() if v}
    for ext in ("cmt", "proof"):
        with open(os.path.join(work, f"{name}.{ext}"), "rb") as fh:
            data = fh.read()
        rec[ext] = base64.b64encode(data).decode()
        rec[f"{ext}_sha256"] = hashlib.sha256(data).hexdigest()
    return rec


def pair_bytes(pair: dict, ext: str) -> bytes:
    """A pair's `.cmt` or `.proof` bytes; raises where they do not match
    their sha256."""
    data = base64.b64decode(pair[ext])
    if hashlib.sha256(data).hexdigest() != pair[f"{ext}_sha256"]:
        raise ValueError(f"{pair['made_by']} {pair['name']}: .{ext} does "
                         f"not match its sha256")
    return data


def verify_argv(pair: dict, work: str) -> List[str]:
    """Write the pair's `.cmt` and `.proof` into `work`; its `--verify`
    arguments with every file named by its path there."""
    argv = list(pair["argv"]["verify"])
    for flag in ("-d", "--cmt-name", "--proof-name"):
        i = argv.index(flag) + 1
        argv[i] = os.path.join(work, argv[i])
    for ext, flag in (("cmt", "--cmt-name"), ("proof", "--proof-name")):
        with open(argv[argv.index(flag) + 1], "wb") as fh:
            fh.write(pair_bytes(pair, ext))
    return argv


def load(path: str = OUT) -> dict:
    with open(path) as fh:
        return json.load(fh)


def store(path: str, made_by: str, maker: dict, recs: List[dict]) -> None:
    """Write `recs` and their maker into the file at `path` in place of
    that maker's pairs, keeping the other maker's."""
    doc = load(path) if os.path.exists(path) else {"makers": {}, "pairs": []}
    pairs = [p for p in doc["pairs"] if p["made_by"] != made_by] + recs
    pairs.sort(key=lambda p: (p["made_by"] != "reef_tpu_torch", p["name"]))
    doc["makers"][made_by] = maker
    doc["pairs"] = pairs
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def card_maker(rev: str) -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return {"card": smi, "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "rev": rev}


def make(names: List[str], reference: bool,
         run: Callable[..., dict] = run_case) -> List[dict]:
    """Every named case, each in a scratch directory of its own; raises
    CaseRefused at the first case refused, the launch floors included."""
    recs = []
    for name in names:
        with tempfile.TemporaryDirectory() as work:
            rec = run(name, work, reference)
        if not reference:
            bad = refusals(CASES[name], rec)
            if bad:
                raise CaseRefused(f"{name}: the prove process launched "
                                  f"{bad} no time ({rec['launches']})")
        print(json.dumps({"case": name, "made_by": rec["made_by"],
                          "seconds": rec["seconds"],
                          "launches": rec.get("launches"),
                          "resume": rec.get("resume"),
                          "cmt_bytes": len(pair_bytes(rec, "cmt")),
                          "proof_bytes": len(pair_bytes(rec, "proof"))}),
              flush=True)
        recs.append(rec)
    return recs


def role(counts: str, argv: List[str]) -> int:
    """The prove process's runner: the CLI, then its launch counts; the
    counts so far also next to each checkpoint, before it is saved."""
    from reef_tpu_torch import cli
    from reef_tpu_torch.utils import cudabuild, serialize
    save = serialize.save

    def dump(path: str) -> None:
        with open(path, "w") as fh:
            json.dump(cudabuild.launch_counts(), fh)

    def save_counted(path: str, kind: str, obj) -> int:
        if kind == "ckpt":
            dump(path + AT_CHECKPOINT)
        return save(path, kind, obj)

    serialize.save = save_counted
    try:
        cli.main(argv)
    finally:
        serialize.save = save
        dump(counts)
    return 0


def build() -> None:
    """The kernels and the native host libraries, once, before the role
    processes load them."""
    from reef_tpu_torch.ec import native_msm
    from reef_tpu_torch.frontend import native_solver
    from reef_tpu_torch.ops import native_fieldvec
    from reef_tpu_torch.utils import cudabuild
    cudabuild.build()
    for mod in (native_msm, native_fieldvec, native_solver):
        if mod._load() is None:
            raise RuntimeError(f"{mod.__name__}: its library did not build")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["role"]:
        return role(argv[1], argv[2:])
    ap = argparse.ArgumentParser(prog="card_pairs")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--rev", required=True,
                    help="the commit the pairs are made at (40 hex digits, "
                         "then optionally what the tree held beyond it)")
    ap.add_argument("--reference", action="store_true",
                    help="run the JAX package's CLI on the CPU instead")
    args = ap.parse_args(argv)
    if not REV.match(args.rev):
        ap.error(f"--rev {args.rev!r} does not start with a 40-hex commit")
    if args.reference:
        maker = {"device": "cpu", "rev": args.rev}
    else:
        import torch
        if not torch.cuda.is_available():
            print("card_pairs: torch sees no CUDA device", file=sys.stderr)
            return 2
        build()
        maker = card_maker(args.rev)
    recs = make(list(REFERENCE_CASES if args.reference else CASES),
                args.reference)
    store(args.out, MAKERS[args.reference], maker, recs)
    print(json.dumps({"ok": True, "out": args.out, "pairs": len(recs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
