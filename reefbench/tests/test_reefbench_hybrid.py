"""The plain check of hybrid (`-y`) proofs against the port at a tiny size
on the CPU (`--device cpu`, the host routes): honest `-y` and `-p -y`
proofs pass, each altered part is refused under its own label, and the
run's judge counts them."""

from __future__ import annotations

import contextlib
import io
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import check  # noqa: E402
from harness.traffic import Cycle  # noqa: E402
from reference import artifact, commitment, proof  # noqa: E402
from test_reefbench_reference import DNA, MOTIF, cli, \
    committed_and_proved, dna_doc  # noqa: E402

ASCII = list(range(128))
NEEDLE = "needleinhaystack"


def dna_case(seed):
    doc = dna_doc(seed)
    return doc, f"^.{{{len(doc) - len(MOTIF)}}}{MOTIF}.*"


@pytest.fixture(scope="module")
def dna_cycles(tmp_path_factory):
    """Two `dna -y` cycles of about 1,000 bytes: (doc, regex, commit
    seed, .cmt, .proof, verdict)."""
    out = []
    for k in range(2):
        doc, regex = dna_case(11 + k)
        d = tmp_path_factory.mktemp(f"dna_y{k}")
        seed = 2**40 + 17 + k
        cmt, prf = committed_and_proved(d, "dna", doc, regex, seed, ["-y"])
        said = cli("dna", "--verify", "-d", str(d / "doc.txt"), "-r", regex,
                   "-y", "--cmt-name", str(d / "doc.cmt"), "--proof-name",
                   str(d / "doc.proof"))
        out.append((doc, regex, seed, cmt, prf,
                    "Verification PASSED" in said))
    return out


@pytest.fixture(scope="module")
def ascii_py(tmp_path_factory):
    """An `ascii -p -y` proof at `proj_hybrid`'s shape, 2,048 bytes."""
    n = 2048
    doc = ("h" * (n - len(NEEDLE)) + NEEDLE).encode()
    regex = f"^.{{{n - len(NEEDLE)}}}{NEEDLE}.*"
    cmt, prf = committed_and_proved(tmp_path_factory.mktemp("ascii_py"),
                                    "ascii", doc, regex, 93, ["-p", "-y"])
    return doc, cmt, prf


def loaded(cmt_bytes, proof_bytes):
    return artifact.loads(cmt_bytes, "cmt"), \
        artifact.loads(proof_bytes, "proof")


def test_the_equality_proof_fields_are_the_ports():
    import dataclasses
    from reef_tpu_torch.backend import commitment as cm
    assert artifact.FIELDS["EqualityProof"] == tuple(
        f.name for f in dataclasses.fields(cm.EqualityProof))


def test_honest_hybrid_proofs_hold(dna_cycles, ascii_py):
    doc, _, _, cmt, prf, _ = dna_cycles[0]
    assert proof.mismatches(*loaded(cmt, prf), commitment.udoc(DNA, doc),
                            ["-y"]) == []
    doc, cmt, prf = ascii_py
    assert proof.mismatches(*loaded(cmt, prf), commitment.udoc(ASCII, doc),
                            ["-p", "-y"]) == []


def _shift_zn(p):
    p.ivc.zn[:] = [z + 1 for z in p.ivc.zn]


def _claim(p):
    p.consist.hash_d += 1


def _a_final(p):
    p.consist.eval_proof.a_final += 1


def _v_prime_is_v(p):
    p.consist.v_prime_commit = p.consist.v_commit


def _z(p):
    p.consist.eq_proof.z += 1


def _l_is_v_prime(p):
    p.consist.l_commit = p.consist.v_prime_commit


def _no_l(p):
    p.consist.l_commit = None


# the x_k are drawn after C_v' enters the transcript, so a proof whose
# C_v' is another commitment folds the document by other rounds too
MUTANTS = {
    "zn shifted": (_shift_zn, ["point not the circuit's",
                               "claim not the circuit's"]),
    "hash_d": (_claim, ["claim not the circuit's"]),
    "a_final": (_a_final, ["claim not the document's", "opening"]),
    "v_prime_commit": (_v_prime_is_v, ["claim not the document's",
                                       "opening"]),
    "eq_proof.z": (_z, ["split"]),
    "l_commit": (_l_is_v_prime, ["split"]),
    "no split": (_no_l, ["no hybrid split"]),
}


@pytest.mark.parametrize("case", ["dna -y", "ascii -p -y"])
@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_each_altered_part_is_refused(dna_cycles, ascii_py, case, mutant):
    if case == "dna -y":
        doc, _, _, cmt, prf, _ = dna_cycles[0]
        u, flags = commitment.udoc(DNA, doc), ["-y"]
    else:
        doc, cmt, prf = ascii_py
        u, flags = commitment.udoc(ASCII, doc), ["-p", "-y"]
    c, p = loaded(cmt, prf)
    alter, labels = MUTANTS[mutant]
    if flags == ["-p", "-y"] and mutant == "zn shifted":
        # no suffix of the point is left in zn: all of it reads as the
        # projection's prefix, as without -y
        labels = ["projection prefix not bits"] + labels
    alter(p)
    assert proof.mismatches(c, p, u, flags) == labels


def test_a_proof_judged_against_another_document(dna_cycles, ascii_py):
    doc, _, _, cmt, prf, _ = dna_cycles[0]
    other = bytearray(doc)
    other[3] = ord("A") if other[3] != ord("A") else ord("G")
    assert proof.mismatches(*loaded(cmt, prf),
                            commitment.udoc(DNA, bytes(other)),
                            ["-y"]) == ["claim not the document's"]
    doc, cmt, prf = ascii_py
    assert proof.mismatches(*loaded(cmt, prf),
                            commitment.udoc(ASCII, b"g" + doc[1:]),
                            ["-p", "-y"]) == ["claim not the document's"]


def test_merkle_proofs_have_no_plain_check(dna_cycles):
    doc, _, _, cmt, prf, _ = dna_cycles[0]
    for flags in (["-m"], ["-m", "-y"]):
        with pytest.raises(ValueError, match="Merkle"):
            proof.mismatches(*loaded(cmt, prf), commitment.udoc(DNA, doc),
                             flags)


class Docs:
    def __init__(self, docs):
        self.docs = docs

    def document(self, key):
        return self.docs[key]


def judged(dna_cycles, alter=None):
    """`check.judge_run` over the two cycles' commit, prove and verify
    records; `alter` changes the second proof before it is judged."""
    from reef_tpu_torch.utils import serialize
    done, docs = [], {}
    for i, (doc, regex, seed, cmt, prf, said) in enumerate(dna_cycles):
        key = ("doc", i)
        docs[key] = doc
        cyc = Cycle(i, key, regex, seed, ["commit", "prove", "verify"])
        if alter is not None and i == 1:
            obj = serialize.loads(prf, "proof")
            alter(obj)
            prf = serialize.dumps("proof", obj)
        for role in cyc.roles:
            done.append({"role": role, "cycle": cyc, "ok": True,
                         "verdict": said if role == "verify" else None,
                         "cmt": cmt, "proof": prf})
    config = {"alphabet": "dna", "flags": ["-y"]}
    with contextlib.redirect_stdout(io.StringIO()):
        return check.judge_run(config, Docs(docs), done, 2**33 + 5)


def test_the_run_judges_hybrid_proofs(dna_cycles):
    assert all(c[5] for c in dna_cycles)
    checks = judged(dna_cycles)
    assert {k: v for k, (v, _) in checks.items()} == {
        "commitments_off": 0, "verdicts_off": 0, "proofs_off": 0,
        "failed_requests": 0}
    assert check.is_correct(checks)
    checks = judged(dna_cycles, _a_final)
    assert checks["proofs_off"] == (1, 0)
    assert not check.is_correct(checks)
