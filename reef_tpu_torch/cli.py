"""CLI: the four party roles sharing one entry point.

Mirrors the reference's clap interface (config.rs:15-124, main.rs):

  python -m reef_tpu_torch.cli ascii --commit -d doc.txt
  python -m reef_tpu_torch.cli ascii --prove  -d doc.txt -r 'hello.*' [-b N] [-p] [-y] [-m] [-n]
  python -m reef_tpu_torch.cli ascii --verify -d doc.txt -r 'hello.*' [...]
  python -m reef_tpu_torch.cli ascii --e2e    -d doc.txt -r 'hello.*' [...]

--device {cuda,cpu} (default cuda) picks the engine device of the device
routes, which backend/routes.py chooses for each operation; on the CPU
every operation stays on the host.  Without a CUDA device, only --device
cpu runs.

Alphabets: ascii (0..128), utf8, dna (ACGT); transforms --alpha-numeric,
--ignore-whitespace, --case-insensitive (config.rs:291-420).
Artifacts: <doc>.cmt (public), <doc>.cmtkey (prover secret blind seed),
reg_<re>.proof.

--metrics FILE appends CSV rows in the reference's schema,
[type, component, name, value, unit], and records the request's spans
(utils/metrics.py `last_spans`).  `time` rows (microseconds) hold the
stage timers and the spans, each name summed over its spans on every
thread (the folds, the second Spartan proof, the consistency proof and
the IVC check run on threads of their own, so a name can sum to more
than the wall of the stage around it):

  Host         load, save (artifacts), gc (the collector, any thread)
  CommitmentGen generation; doc_transform, rows (Hyrax row MSMs),
               row_hash
  Compiler     regex_normalization+fa_builder; r1cs_init (pub_setup),
               table, circuit (their cache misses), restamp (a circuit
               cache hit under another document commitment hash)
  Solver       fa_solver+wit (solver and folds); solve (each batch on
               the request thread), wait_fold (blocked on the fold
               worker's queue and join)
  Prover       doc_transform, prewarm, fold_step (the fold worker),
               compressed_snark, spartan.sumcheck1, spartan.sumcheck2,
               spartan.open (each Spartan proof, the CAP's too),
               wait_spartan2, consistency_proof, wait_consistency,
               ipa (each IPA, any thread)
  MSM          basis_upload, and the device MSM's scalars, upload,
               kernels, combine (the read-back, with the wait for the
               kernels)
  Mesh         on a process mesh of more than one device: scalars (the
               shards' input copies), issue (the shards' launches),
               gather (their results summed on the lead)
  Verifier     setup, snark_verification (starts the IVC check's
               thread), ivc_check, consistency_verification:
               consistency, wait_ivc

`count` rows (unit `events`): Host gc_collections; Compiler
table_cache_hit/_miss, circuit_cache_hit/_miss, circuit_restamp; Solver
device_cache_hit/_miss; Prover fold_steps; MSM basis_upload; IPA device,
mesh, host (the round engine each IPA took); Mesh shards, gather_bytes.
`constraints` and `space` rows as in the reference.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import sys
import time
from typing import List, Optional

from .backend import framework as FW
from .frontend.safa import SAFA, from_regex
from .utils import device, metrics, serialize
from .utils.metrics import Metrics


def build_alphabet(args) -> List[int]:
    if args.alphabet == "ascii":
        ab = list(range(128))
    elif args.alphabet == "utf8":
        # FULL unicode (config.rs:253-263 semantics): the alphabet is not
        # enumerated — consuming SAFA edges are range-compressed
        # derivative classes and table rows carry (char_lo, char_hi)
        # codepoint ranges checked in-circuit (frontend/safa.py
        # _add_derivatives, backend/table.py).
        ab = None
    elif args.alphabet == "snort":
        # mirrors the reference's stub: Config::Snort returns an empty
        # alphabet with a TODO (config.rs:104-110, 429, 438)
        raise ValueError("snort alphabet is a stub (unimplemented in the "
                         "reference too: config.rs:429 'TODO')")
    elif args.alphabet == "dna":
        ab = [ord(c) for c in "ACGT"]
    else:
        raise ValueError(args.alphabet)

    if ab is None:
        assert not (args.alpha_numeric or getattr(args, "basic_english",
                                                  False)
                    or args.ignore_whitespace or args.case_insensitive), \
            "char transforms apply to enumerated alphabets (ascii/dna)"
        return ab
    if args.alpha_numeric:
        keep = set(range(ord("a"), ord("z") + 1)) | \
            set(range(ord("A"), ord("Z") + 1)) | \
            set(range(ord("0"), ord("9") + 1))
        ab = [c for c in ab if c in keep]
    if getattr(args, "basic_english", False):
        # the reference's BasicEnglishEncoder set (config.rs:353-368):
        # letters + digits + [,.!?;:-'"$&*+@\] + space/newline
        keep = set(range(ord("a"), ord("z") + 1)) | \
            set(range(ord("A"), ord("Z") + 1)) | \
            set(range(ord("0"), ord("9") + 1)) | \
            {ord(c) for c in ",.!?;:-'\"$&*+@\\ \n"}
        ab = [c for c in ab if c in keep]
    if args.ignore_whitespace:
        ws = {ord(c) for c in " \t\n\r\f\v"}
        ab = [c for c in ab if c not in ws]
    if args.case_insensitive:
        ab = sorted({ord(chr(c).lower()) for c in ab})
    return ab


def read_doc(path: str, args, ab: List[int]) -> List[int]:
    with open(path, "rb") as fh:
        raw = fh.read()
    if args.alphabet == "utf8":
        codes = [ord(c) for c in raw.decode("utf-8")]
    else:
        codes = list(raw)
    if args.case_insensitive:
        codes = [ord(chr(c).lower()) for c in codes]
    if args.alpha_numeric or args.ignore_whitespace:
        abset = set(ab)
        codes = [c for c in codes if c in abset]
    if args.alphabet == "dna":
        for c in codes:
            assert chr(c) in "ACGT", f"{c:#04x} not in the alphabet"
    return codes


def artifact_names(args):
    doc_base = os.path.basename(args.doc)
    cmt = args.cmt_name or f"{doc_base}.cmt"
    key = cmt + "key"
    re_tag = hashlib.sha256(args.re.encode()).hexdigest()[:12] if args.re \
        else "none"
    proof = args.proof_name or f"reg_{re_tag}.proof"
    return cmt, key, proof


_SAFA_CACHE: dict = {}


def build_safa(args, ab: Optional[List[int]]) -> SAFA:
    """SAFA construction is deterministic in (regex, alphabet, negate):
    cache it so a serve-mode worker proving the SAME policy regex over
    many documents builds the automaton once (the reference re-derives
    per process, main.rs:57-72; a proving service amortizes).  Each build
    is `from_regex`'s, from a fresh process's regex terms, so the
    automaton, and so the proof, does not depend on the regexes the
    process built before."""
    ab_str = None if ab is None else "".join(chr(c) for c in ab)
    key = (args.re, ab_str, bool(args.negate))
    safa = _SAFA_CACHE.get(key)
    if safa is None:
        safa = from_regex(ab_str, args.re)
        if args.negate:
            safa = safa.negate()
        if len(_SAFA_CACHE) > 16:
            _SAFA_CACHE.clear()
        _SAFA_CACHE[key] = safa
    return safa


def main(argv=None):
    real = sys.argv[1:] if argv is None else argv
    if real and real[0] == "serve":
        return serve()
    try:
        return _main(argv)
    except (ValueError, AssertionError) as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)


def serve():
    """Long-lived JSON-lines worker: one CLI request per stdin line.

    `python -m reef_tpu_torch.cli serve` reads {"argv": [...]} objects (the same
    arguments as one-shot invocations) and answers one JSON line per
    request: {"ok": bool, "output": str, "error": str?}.  A single process
    amortizes the fixed per-invocation costs — the torch import, the
    kernel builds and device bases, generator/constant caches, Poseidon gadget templates and the
    circuit-stack cache — across every proof, which is the deployment
    shape for a proving service (the reference is strictly one-shot;
    framework.rs has no server mode)."""
    import contextlib
    import io
    import json

    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        resp = {"ok": False, "output": ""}
        try:
            req = json.loads(line)
            argv = req["argv"]
            assert isinstance(argv, list) and all(
                isinstance(a, str) for a in argv), "argv: list of strings"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                try:
                    _main(argv)
                    resp["ok"] = True
                except SystemExit as e:   # argparse errors / FAILED verify
                    resp["ok"] = (e.code or 0) == 0
                    if not resp["ok"]:
                        resp["error"] = f"exit {e.code}"
            resp["output"] = buf.getvalue()
        except Exception as e:
            resp["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(resp), flush=True)


def _main(argv=None):
    ap = argparse.ArgumentParser(prog="reef_tpu_torch")
    ap.add_argument("alphabet", choices=["ascii", "utf8", "dna", "snort"])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--commit", action="store_true")
    mode.add_argument("--prove", action="store_true")
    mode.add_argument("--verify", action="store_true")
    mode.add_argument("--e2e", action="store_true")
    ap.add_argument("-d", "--doc", required=True)
    ap.add_argument("-r", "--re", default=None)
    ap.add_argument("-b", "--batch-size", type=int, default=0)
    ap.add_argument("-p", "--projections", action="store_true")
    ap.add_argument("-y", "--hybrid", action="store_true")
    ap.add_argument("-m", "--merkle", action="store_true")
    ap.add_argument("-n", "--negate", action="store_true")
    ap.add_argument("--cmt-name", default=None)
    ap.add_argument("--seed", type=int, default=None,
                    help="deterministic commitment randomness (conformance "
                         "testing; production uses OS randomness, mirroring "
                         "the reference's OsRng salts, commitment.rs:152)")
    ap.add_argument("--proof-name", default=None)
    ap.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="mid-proof checkpoint/resume: save resumable IVC "
                         "state here every --checkpoint-every folds; if the "
                         "file exists, resume from it (prover-secret; "
                         "removed when the proof completes)")
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--alpha-numeric", action="store_true")
    ap.add_argument("--basic-english", action="store_true")
    ap.add_argument("--ignore-whitespace", action="store_true")
    ap.add_argument("--case-insensitive", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="engine device of the device routes; cpu runs "
                         "the kernels' plain versions")
    args = ap.parse_args(argv)
    device.select(args.device)

    print("reef_tpu_torch")
    ab = build_alphabet(args)
    mt = Metrics()
    with (metrics.recording(mt) if args.metrics
          else contextlib.nullcontext()):
        _roles(args, ab, mt)
    if args.metrics:
        mt.write_csv(args.metrics)


def _roles(args, ab: Optional[List[int]], mt: Metrics):
    """The roles `args` asks for, in order: commit, prove, verify."""
    cmt_path, key_path, proof_path = artifact_names(args)

    if args.commit or args.e2e:
        with metrics.span("Host", "load"):
            doc = read_doc(args.doc, args, ab)
        mt.tic("CommitmentGen", "generation")
        commit, secret = FW.run_committer(doc, ab, args.merkle,
                                          seed=args.seed)
        mt.stop("CommitmentGen", "generation")
        with metrics.span("Host", "save"):
            n = serialize.save(cmt_path, "cmt", commit)
            if secret is not None:
                serialize.save(key_path, "cmtkey", secret)
        mt.space("CommitmentGen", "commitment", n)
        print(f"wrote {cmt_path}")

    if args.prove or args.e2e:
        assert args.re, "Regular Expression not found"
        with metrics.span("Host", "load"):
            doc = read_doc(args.doc, args, ab)
            commit = serialize.load(cmt_path, "cmt")
            secret = serialize.load(key_path, "cmtkey") if not args.merkle \
                else None
        mt.tic("Compiler", "regex_normalization+fa_builder")
        safa = build_safa(args, ab)
        mt.stop("Compiler", "regex_normalization+fa_builder")
        proofs = FW.run_prover(commit, secret, safa, doc,
                               batch_size=args.batch_size,
                               projections=args.projections,
                               hybrid=args.hybrid, merkle=args.merkle,
                               metrics=mt, checkpoint_path=args.checkpoint,
                               checkpoint_every=args.checkpoint_every)
        with metrics.span("Host", "save"):
            n = serialize.save(proof_path, "proof", proofs)
        mt.space("Prover", "snark_size", n)
        print(f"wrote {proof_path}")

    if args.verify or args.e2e:
        assert args.re, "Regular Expression not found"
        with metrics.span("Host", "load"):
            commit = serialize.load(cmt_path, "cmt")
            proofs = serialize.load(proof_path, "proof")
        safa = build_safa(args, ab)
        ok = FW.run_verifier(commit, safa, proofs,
                             batch_size=args.batch_size,
                             projections=args.projections,
                             hybrid=args.hybrid, merkle=args.merkle,
                             metrics=mt)
        print("Verification PASSED" if ok else "Verification FAILED")
        if not ok:
            sys.exit(1)

if __name__ == "__main__":
    main()
