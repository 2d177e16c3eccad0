"""The plain reference against the port at a tiny size on the CPU
(`--device cpu`, the host routes): the artifacts read, the commitment
worked out again, the proofs' claims and openings, Poseidon, the curve
and the match verdict."""

from __future__ import annotations

import contextlib
import io
import os
import random
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import guard  # noqa: E402
from reference import artifact, commitment, curve, poseidon, proof, \
    verdict  # noqa: E402

DNA = [ord(c) for c in "ACGT"]
MOTIF = "ATGGGCTACAGAAACCGTGCCAAA"


def cli(*argv):
    from reef_tpu_torch import cli as port
    with contextlib.redirect_stdout(io.StringIO()) as out:
        port.main([*argv, "--device", "cpu"])
    return out.getvalue()


def committed_and_proved(d, alphabet, doc, regex, seed, flags=()):
    path = str(d / "doc.txt")
    with open(path, "wb") as fh:
        fh.write(doc)
    cmt, prf = str(d / "doc.cmt"), str(d / "doc.proof")
    cli(alphabet, "--commit", "-d", path, "--seed", str(seed),
        "--cmt-name", cmt)
    cli(alphabet, "--prove", "-d", path, "-r", regex, *flags,
        "--cmt-name", cmt, "--proof-name", prf)
    with open(cmt, "rb") as fh:
        cmt_bytes = fh.read()
    with open(prf, "rb") as fh:
        proof_bytes = fh.read()
    return cmt_bytes, proof_bytes


def dna_doc(seed, n=1000):
    rng = random.Random(seed)
    return ("".join(rng.choice("ACGT") for _ in range(n)) + MOTIF).encode()


@pytest.fixture(scope="module")
def dna_pair(tmp_path_factory):
    doc = dna_doc(5)
    regex = f"^.{{{len(doc) - len(MOTIF)}}}{MOTIF}.*"
    cmt, prf = committed_and_proved(tmp_path_factory.mktemp("dna"), "dna",
                                    doc, regex, 2**40 + 3)
    return doc, regex, cmt, prf


def test_commitment_agrees_with_the_port(dna_pair):
    doc, _, cmt_bytes, _ = dna_pair
    cmt = artifact.loads(cmt_bytes, "cmt")
    assert commitment.mismatches(cmt, DNA, doc, 2**40 + 3, 1) == []
    bad = bytearray(doc)
    bad[17] = ord("A") if bad[17] != ord("A") else ord("C")
    assert "row commitments" in commitment.mismatches(
        cmt, DNA, bytes(bad), 2**40 + 3, 1)
    assert "hash salt" in commitment.mismatches(cmt, DNA, doc, 2**40 + 4, 1)


def test_ascii_commitment_agrees_with_the_port(tmp_path):
    doc = b"the quick brown fox jumps over the lazy dog " * 20
    path, cmt = str(tmp_path / "a.txt"), str(tmp_path / "a.cmt")
    with open(path, "wb") as fh:
        fh.write(doc)
    cli("ascii", "--commit", "-d", path, "--seed", "77", "--cmt-name", cmt)
    with open(cmt, "rb") as fh:
        c = artifact.loads(fh.read(), "cmt")
    ascii_ab = list(range(128))
    assert commitment.mismatches(c, ascii_ab, doc, 77, 3) == []
    assert commitment.mismatches(c, ascii_ab, doc[:-1] + b"!", 77, 3)


def test_the_artifact_fields_are_the_ports():
    import dataclasses
    from reef_tpu_torch.backend import commitment as cm
    from reef_tpu_torch.backend import framework, ipa, ivc
    for cls in (framework.ReefCommitment, cm.NLDocCommitment,
                cm.HyraxCommitment, framework.Proofs, cm.ConsistencyProof,
                ipa.IpaProof):
        assert artifact.FIELDS[cls.__name__] == tuple(
            f.name for f in dataclasses.fields(cls))
    assert tuple(f.name for f in dataclasses.fields(ivc.IVCProof))[:2] == \
        artifact.IVC_FIELDS
    with pytest.raises(ValueError):
        artifact.loads(b"REEFTPU1" + bytes(40), "cmt")


def test_the_proof_holds_to_the_document(dna_pair):
    doc, _, cmt_bytes, proof_bytes = dna_pair
    cmt = artifact.loads(cmt_bytes, "cmt")
    prf = artifact.loads(proof_bytes, "proof")
    u = commitment.udoc(DNA, doc)
    assert proof.mismatches(cmt, prf, u, []) == []
    other = bytearray(doc)
    other[3] = ord("A") if other[3] != ord("A") else ord("G")
    assert proof.mismatches(cmt, prf, commitment.udoc(DNA, bytes(other)),
                            [], opening=False) == [
        "claim not the document's", "claim not the circuit's"]
    prf.consist.eval_proof.a_final += 1
    assert proof.mismatches(cmt, prf, u, []) == ["opening"]
    prf.consist.eval_proof.a_final -= 1
    prf.consist.hash_d += 1
    assert proof.mismatches(cmt, prf, u, [], opening=False) == [
        "claim not the document's"]
    prf.consist.hash_d -= 1
    prf.ivc.zn[:] = [z + 1 for z in prf.ivc.zn]
    assert proof.mismatches(cmt, prf, u, [], opening=False) == [
        "point not the circuit's", "claim not the circuit's"]
    with pytest.raises(ValueError):
        proof.mismatches(cmt, prf, u, ["-m"])


def test_a_proof_made_over_another_document_is_refused(tmp_path, dna_pair):
    doc, regex, _, _ = dna_pair
    other = dna_doc(6)
    cmt_bytes, proof_bytes = committed_and_proved(tmp_path, "dna", other,
                                                  regex, 2**40 + 3)
    assert proof.mismatches(artifact.loads(cmt_bytes, "cmt"),
                            artifact.loads(proof_bytes, "proof"),
                            commitment.udoc(DNA, doc), []) == [
        "claim not the document's", "claim not the circuit's"]


def test_a_projected_proof_holds_to_the_document(tmp_path):
    doc = b"abcdefgh" * 120 + b"needleinhaystack"
    regex = f"^.{{{len(doc) - 16}}}needleinhaystack.*"
    cmt_bytes, proof_bytes = committed_and_proved(tmp_path, "ascii", doc,
                                                  regex, 91, ["-p"])
    cmt = artifact.loads(cmt_bytes, "cmt")
    prf = artifact.loads(proof_bytes, "proof")
    u = commitment.udoc(list(range(128)), doc)
    assert proof.mismatches(cmt, prf, u, ["-p"]) == []
    assert proof.mismatches(cmt, prf, commitment.udoc(
        list(range(128)), doc[:-1] + b"l"), ["-p"], opening=False) == [
        "claim not the document's", "claim not the circuit's"]


def test_poseidon_against_the_port():
    from reef_tpu_torch.backend import commitment as cm
    from reef_tpu_torch.backend.step_circuit import StepCircuit
    from reef_tpu_torch.ec.pasta import PALLAS
    from reef_tpu_torch.ops.poseidon_constants import host_permutation_py
    state = [1, 2, 3, 4, 5]
    for p in (curve.P, curve.Q):
        assert poseidon.permute(p, state) == host_permutation_py(p, state)
    assert poseidon.hide(12345, 678) == StepCircuit._hide_host(12345, 678)
    pts = PALLAS.gens(b"x", 7)
    assert poseidon.row_hash(pts) == cm._commit_hash(pts)
    assert all(curve.decompress(curve.compress(pt)) == pt for pt in pts)


def test_verdict():
    assert verdict.matches(f"^.{{3}}{MOTIF}.*", b"ACG" + MOTIF.encode())
    assert not verdict.matches(f"^.{{2}}{MOTIF}.*", b"ACG" + MOTIF.encode())


def test_curve_against_the_port():
    from reef_tpu_torch.ec.pasta import PALLAS
    assert (curve.P, curve.Q) == (PALLAS.p, PALLAS.order)
    gens = curve.generators(b"doc/vec", 5)
    assert list(gens) == PALLAS.gens(b"doc/vec", 5)
    assert curve.hash_to_curve(b"reef/blind") == \
        PALLAS.hash_to_curve(b"reef/blind")
    ks = [3, 2**70 + 1, curve.Q - 2, 0, 12345]
    want = None
    for k, g in zip(ks, gens):
        want = PALLAS.add(want, PALLAS._mul_py(k, g))
    assert curve.to_affine(curve.msm(ks, gens)) == want


def test_the_reference_imports_nothing_of_the_port():
    assert guard.reference_imports(os.path.join(BENCH, "reference")) == []
