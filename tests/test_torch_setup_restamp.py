"""The public setup's circuit cache across documents, on the CPU.

`backend/framework.py` `pub_setup` keeps one circuit stack for each
circuit structure; a hit under another document commitment hash writes
that hash into its few sites (`StepCircuit.restamp_hash`,
`R1CSShape.restamp_A`).  For every Hyrax case of tests/test_torch_frontend
.py's `SETUP_CASES`, two same-length documents are committed under two
seeds and set up in turn (a miss, then two restamps); each time the
stack must equal a cold build under that hash (packed matrices, digest,
native matrix-vector products, the witness of the native program and of
the Python closures), and the digest of a cold build the JAX package's.
A zero hash takes an entry of its own.  Then two documents are proved one after the
other in one process, the second through the restamp, and both proofs
are accepted by the port's verifier and by the JAX package's CLI.
"""

import csv
import dataclasses
import random

import pytest
import torch

from _torch_support import (fresh_reference_terms,  # noqa: F401
                            no_compile_cache_writes, one_torch_thread,
                            run_cli)
from reef_tpu import cli as ref_cli
from reef_tpu.backend import framework as ref_fw
from reef_tpu.utils import serialize as ref_sz
from reef_tpu_torch import cli
from reef_tpu_torch.backend import framework as FW
from reef_tpu_torch.backend.table import doc_transform
from reef_tpu_torch.ops import native_fieldvec as FV
from reef_tpu_torch.utils import device, metrics
from reef_tpu_torch.utils import serialize as sz
from test_torch_frontend import SETUP_CASES, build

HYRAX_CASES = [c for c in SETUP_CASES if not SETUP_CASES[c][6]]


@pytest.fixture
def host_routes(monkeypatch):
    # the JAX package's host routes (the port's CPU engine keeps to
    # the host)
    monkeypatch.setenv("REEF_DEVICE_MSM", "0")
    monkeypatch.setenv("REEF_DEVICE_SUMCHECK", "0")
    monkeypatch.setattr(device, "_SELECTED", torch.device("cpu"))
    monkeypatch.setattr(FW, "_CIRCUIT_CACHE", {})
    monkeypatch.setattr(FW, "_TT_CACHE", {})


def _cold(setup):
    """`setup()` with the port's caches empty, restored after."""
    saved = dict(FW._CIRCUIT_CACHE), dict(FW._TT_CACHE)
    FW._CIRCUIT_CACHE.clear()
    FW._TT_CACHE.clear()
    try:
        return setup()
    finally:
        FW._CIRCUIT_CACHE.clear()
        FW._CIRCUIT_CACHE.update(saved[0])
        FW._TT_CACHE.clear()
        FW._TT_CACHE.update(saved[1])


def _python_witness(cs, inputs):
    """The witness by the computers' Python closures alone."""
    z = [0] * cs.n_vars
    z[0] = 1
    for name in cs.input_names:
        z[cs.names[name]] = inputs[name] % cs.f.p
    for idx, fn, _op in cs.computers:
        z[idx] = fn(z) % cs.f.p
    return z


def _summary(stack, seed):
    """What must equal between a restamped stack and a cold one."""
    tt, circuit, aug, shape, wc, ec, mc = stack
    rng = random.Random(seed)
    p = shape.f.p
    cs = aug.cs
    inputs = {n: rng.randrange(p) for n in cs.input_names}
    z = [rng.randrange(p) for _ in range(2 * shape.w_pad)]
    packed = aug.compiled.witness_packed(inputs)
    return {
        "packed": [(r.tobytes(), c.tobytes(), bytes(v))
                   for r, c, v in shape._packed_mats],
        "coo_A": shape.A[:64] + shape.A[-64:],
        "digest": shape.digest,
        "matvecs": [list(v) for v in shape.matvecs(z)],
        "witness": list(packed),
        "python_witness": _python_witness(cs, inputs),
        "committers": (wc.n, ec.n),
    }


@pytest.mark.parametrize("case", HYRAX_CASES)
def test_restamped_setup_equals_a_cold_build(case, host_routes):
    rs, ab, doc, bs, proj, hybrid, merkle, negate = SETUP_CASES[case]
    assert FV.available()
    port, ref = build(ab, rs, negate)
    docs = [doc, doc[::-1]]
    commits = []
    for seed, d in zip((3, 4), docs):
        codes = [ord(c) for c in d]
        commit, _ = FW.run_committer(codes, port.ab, False, seed=seed)
        commits.append((commit, doc_transform(port.ab, codes)))
    assert commits[0][0].doc_commit_hash() != commits[1][0].doc_commit_hash()

    def setup(commit, udoc):
        return FW.pub_setup(port, commit, bs, proj, hybrid, False, udoc)

    mt = metrics.Metrics()
    seen, cold = [], {}
    for n in (0, 1, 0):
        commit, udoc = commits[n]
        with metrics.recording(mt):
            warm = setup(commit, udoc)
        assert warm[1].doc_commit_hash == commit.doc_commit_hash()
        seen.append(warm[1:6])
        if n not in cold:         # a cold build's, and the JAX package's
            stack = _cold(lambda: setup(commit, udoc))
            assert stack[1] is not warm[1]
            ref_commit = ref_sz.loads(sz.dumps("cmt", commit), "cmt")
            want = ref_fw.pub_setup(ref, ref_commit, bs, proj, hybrid,
                                    False, udoc=udoc)
            assert stack[3].digest == want[3].digest, (case, n)
            cold[n] = _summary(stack, n)
        assert _summary(warm, n) == cold[n], (case, n)
    # one stack, built once, restamped twice; the verifier's setup (no
    # document) under the last hash hits without a restamp
    assert all(a is b for s in seen[1:] for a, b in zip(s, seen[0]))
    assert mt.events[("Compiler", "circuit_cache_miss")] == 1
    assert mt.events[("Compiler", "circuit_cache_hit")] == 2
    assert mt.events[("Compiler", "circuit_restamp")] == 2
    assert mt.timers[("Compiler", "restamp")] > 0
    with metrics.recording(mt):
        assert setup(commits[0][0], None)[1] is seen[0][0]
    assert mt.events[("Compiler", "circuit_restamp")] == 2

    # a zero hash leaves A's ONE-wire entry out: an entry of its own
    zero = dataclasses.replace(
        commits[0][0], nldoc=dataclasses.replace(commits[0][0].nldoc,
                                                 doc_commit_hash=0))
    with metrics.recording(mt):
        got = setup(zero, commits[0][1])
    assert got[1] is not seen[0][0] and got[1].hash_sites == []
    assert mt.events[("Compiler", "circuit_cache_miss")] == 2
    assert mt.events[("Compiler", "circuit_restamp")] == 2
    assert len(got[3]._packed_mats[0][0]) == \
        len(seen[0][2]._packed_mats[0][0]) - len(seen[0][0].hash_sites)
    with metrics.recording(mt):
        assert setup(commits[1][0], None)[1] is seen[0][0]
    assert mt.events[("Compiler", "circuit_restamp")] == 3


def test_second_document_proves_through_the_restamp(monkeypatch, tmp_path,
                                                    host_routes):
    """Two same-length DNA documents, committed and proved one after the
    other in one process: the second prove restamps the first's stack,
    and both proofs verify on the port and on the JAX package's CLI."""
    monkeypatch.chdir(tmp_path)
    fresh_reference_terms()
    rx = ".*TTG.*"
    for name, doc in (("d1.txt", "ACGTTGCAAC"), ("d2.txt", "CATTGGACCA")):
        (tmp_path / name).write_text(doc)

    def argv(mode, n, *extra):
        return ["dna", mode, "-d", f"d{n}.txt", "-r", rx,
                "--proof-name", f"p{n}.proof", *extra]

    port = ["--device", "cpu"]
    for n in (1, 2):
        run_cli(cli.main, argv("--commit", n, *port))
        run_cli(cli.main, argv("--prove", n, *port, "--metrics",
                               f"prove{n}.csv"))
    with open("prove2.csv", newline="") as fh:
        counts = {(r[1], r[2]): int(r[3]) for r in csv.reader(fh)
                  if r[0] == "count"}
    assert counts[("Compiler", "circuit_cache_hit")] == 1
    assert counts[("Compiler", "circuit_restamp")] == 1
    assert ("Compiler", "circuit_cache_miss") not in counts
    for n in (1, 2, 1):            # each verify restamps the stack back
        assert "Verification PASSED" in run_cli(
            cli.main, argv("--verify", n, *port))
    for n in (1, 2):
        assert "Verification PASSED" in run_cli(ref_cli.main,
                                                argv("--verify", n))
