"""Forged proofs: the port's verifier must refuse what the JAX package's
refuses, on the CPU.

The attacks of tests/test_ivc_adversarial.py, made differential.  The
smoke proof (`.*b` over `ab`, document `aaaaaaaab`, batch 2) is built by
the port (`backend/framework.py` `run_committer`, `run_prover`, device
cpu) and then:

  * a seeded sample of its int leaves (the whole object graph: the IVC
    instances, both Spartan proofs, their IPA openings, the consistency
    proof and the CAP) is mutated one at a time; each mutated proof must
    be rejected by the port's `run_verifier`, and, written by the port's
    `utils/serialize.py` and read by the reference's, by the reference's
    `run_verifier`.  A few leaves of a reference-made proof go the other
    way;
  * hostile compressed points (an x off the curve, an x >= p, an unknown
    flag) in each point field of the IVC proof are rejected cleanly by
    both verifiers (False, never another exception);
  * a prover whose nonnative limb witnesses encode v + p either fails,
    as the reference's prover does, or makes a proof both verifiers
    reject;
  * the 255-bit decomposition alias satisfies the port's truncation
    constraints and changes its output, exactly as in the reference;
  * flipped bytes and truncations of the port's `.cmt` and `.proof`
    files are refused by each package's loader or verifier; with the
    file's checksum made good again after the flip, by its decoder or
    its verifier; and by each package's `cli --verify` alike.

A verifier "rejects" by returning False or raising its package's
VerifyError; any other exception is a crash and fails the test.
"""

import copy
import random

import pytest
import torch

from _torch_support import cli_verdict as _cli_verdict
from _torch_support import resealed as _resealed
from _torch_support import verdict as _verdict
from _torch_support import (fresh_reference_terms,  # noqa: F401
                            no_compile_cache_writes, one_torch_thread,
                            repo_module, run_cli)
from reef_tpu import cli as ref_cli
from reef_tpu import errors as ref_errors
from reef_tpu.backend import framework as ref_fw
from reef_tpu.backend import ivc_circuit as ref_ic
from reef_tpu.backend import r1cs as ref_r1cs
from reef_tpu.ec import pasta as ref_pasta
from reef_tpu.frontend import parser as ref_parser
from reef_tpu.frontend import regex as ref_regex
from reef_tpu.frontend.safa import SAFA as RefSAFA
from reef_tpu.ops import field as ref_field
from reef_tpu.utils import serialize as ref_sz
from reef_tpu_torch import cli, errors
from reef_tpu_torch.backend import framework as FW
from reef_tpu_torch.backend import ivc_circuit as IC
from reef_tpu_torch.backend import r1cs
from reef_tpu_torch.ec.pasta import PALLAS, VESTA
from reef_tpu_torch.frontend.safa import from_regex
from reef_tpu_torch.ops import field as F
from reef_tpu_torch.utils import device
from reef_tpu_torch.utils import serialize as sz

REGEX, ALPHABET, DOC, BATCH = ".*b", "ab", "aaaaaaaab", 2
CODES = [ord(c) for c in DOC]
POINT_FIELDS = ["U1_W", "U1_E", "U2_W", "U2_E", "u2_W", "T_last"]
BURN = 24             # the port's proof's leaves (the reference's count)
BURN_REVERSE = 8      # a reference-made proof's leaves
FLIPS = 12            # flipped bytes a file, raw and with a good checksum


class Smoke:
    """Both packages' automata of REGEX, a port-made commitment and
    proof, and the same commitment as the reference reads it."""


@pytest.fixture(scope="module")
def smoke():
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's host routes (the port's CPU engine keeps to
        # the host)
        mp.setenv("REEF_DEVICE_MSM", "0")
        mp.setenv("REEF_DEVICE_SUMCHECK", "0")
        mp.setattr(device, "_SELECTED", torch.device("cpu"))
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            s = Smoke()
            s.safa = from_regex(ALPHABET, REGEX)
            fresh_reference_terms()
            s.ref_safa = RefSAFA(ALPHABET, ref_regex.simpl(
                ref_parser.parse(REGEX)))
            s.commit, s.dc = FW.run_committer(CODES, s.safa.ab, False,
                                              seed=5)
            s.proofs = FW.run_prover(s.commit, s.dc, s.safa, CODES,
                                     batch_size=BATCH)
            s.ref_commit = ref_sz.loads(sz.dumps("cmt", s.commit), "cmt")
            assert port_verdict(s, s.proofs) == "accept"
            assert ref_verdict(s, s.proofs) == "accept"
            yield s
        finally:
            torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _host_routes(monkeypatch):
    # the JAX package's host routes (the port's CPU engine keeps to
    # the host)
    monkeypatch.setenv("REEF_DEVICE_MSM", "0")
    monkeypatch.setenv("REEF_DEVICE_SUMCHECK", "0")
    monkeypatch.setattr(device, "_SELECTED", torch.device("cpu"))


def port_verdict(s, proofs, commit=None) -> str:
    return _verdict(lambda: FW.run_verifier(
        commit or s.commit, s.safa, proofs, batch_size=BATCH),
        errors.VerifyError)


def ref_verdict(s, proofs, commit=None) -> str:
    """The reference's verdict on the port's objects, written by the
    port's codec and read by the reference's; "refused by the writer"
    where the port's codec will not encode them."""
    try:
        data = sz.dumps("proof", proofs)
    except AssertionError:
        return "refused by the writer"
    ref_proofs = ref_sz.loads(data, "proof")
    return _verdict(lambda: ref_fw.run_verifier(
        commit or s.ref_commit, s.ref_safa, ref_proofs, batch_size=BATCH),
        ref_errors.VerifyError)


# ---------------------------------------------------------------------------
# the mutation burn
# ---------------------------------------------------------------------------

# chip_smoke.py's `int_leaves` and `with_leaf` mutate the card's proof in
# its phase `reject`
_CS = repo_module("chip_smoke.py")
int_leaves, with_leaf = _CS.int_leaves, _CS.with_leaf


def mutated(root, path):
    """A deep copy of `root` with one added to the int at `path`."""
    return with_leaf(root, path, lambda v: v + 1)


def burn_sample(proofs, n: int, seed: int):
    leaves = [pth for pth, _ in int_leaves(proofs)]
    assert len(leaves) > 200, f"leaf walk too shallow: {len(leaves)}"
    return random.Random(seed).sample(leaves, n)


@pytest.fixture(scope="module")
def burn(smoke):
    return burn_sample(smoke.proofs, BURN, 99)


@pytest.mark.parametrize("i", range(BURN))
def test_mutated_port_proof_rejected_by_both(smoke, burn, i):
    """One leaf of the port's proof, plus one: both verifiers reject it
    (the reference through its own codec)."""
    p2 = mutated(smoke.proofs, burn[i])
    assert port_verdict(smoke, p2) == "reject", burn[i]
    assert ref_verdict(smoke, p2) in ("reject", "refused by the writer"), \
        burn[i]


@pytest.fixture(scope="module")
def ref_smoke(smoke):
    """A reference-made proof of the same statement, with the same
    automaton and commitment as the port's."""
    rc, rdc = ref_fw.run_committer(CODES, smoke.ref_safa.ab, False, seed=5)
    assert ref_sz.dumps("cmt", rc) == sz.dumps("cmt", smoke.commit)
    proofs = ref_fw.run_prover(rc, rdc, smoke.ref_safa, CODES,
                               batch_size=BATCH)
    return proofs, burn_sample(proofs, BURN_REVERSE, 199)


@pytest.mark.parametrize("i", range(BURN_REVERSE))
def test_mutated_reference_proof_rejected_by_both(smoke, ref_smoke, i):
    """One leaf of a reference-made proof, plus one, written by the
    reference's codec and read by the port's: both verifiers reject."""
    proofs, sample = ref_smoke
    p2 = mutated(proofs, sample[i])
    assert _verdict(lambda: ref_fw.run_verifier(
        smoke.ref_commit, smoke.ref_safa, p2, batch_size=BATCH),
        ref_errors.VerifyError) == "reject", sample[i]
    try:
        data = ref_sz.dumps("proof", p2)
    except AssertionError:
        return                    # the writer refuses it: refused by both
    assert port_verdict(smoke, sz.loads(data, "proof")) == "reject", \
        sample[i]


def test_unmutated_reference_proof_verifies_in_port(smoke, ref_smoke):
    proofs, _ = ref_smoke
    back = sz.loads(ref_sz.dumps("proof", proofs), "proof")
    assert port_verdict(smoke, back) == "accept"


# ---------------------------------------------------------------------------
# hostile compressed points
# ---------------------------------------------------------------------------

def hostile_points(cv):
    """An x off the curve (walking up from 7 until no square root), a
    non-canonical x = p + 1, and the unknown flag 7."""
    x = 7
    while cv.sqrt((x * x * x + 5) % cv.p) is not None:
        x += 1
    return [(x, 0), (cv.p + 1, 0), (5, 7)]


@pytest.mark.parametrize("point_field", POINT_FIELDS)
def test_hostile_point_rejected_by_both(smoke, point_field):
    cv = PALLAS if point_field in ("U1_W", "U1_E") else VESTA
    ref_cv = (ref_pasta.PALLAS if point_field in ("U1_W", "U1_E")
              else ref_pasta.VESTA)
    hostile = hostile_points(cv)
    assert hostile == hostile_points(ref_cv)
    for comp in hostile:
        p2 = copy.deepcopy(smoke.proofs)
        setattr(p2.ivc, point_field, comp)
        assert port_verdict(smoke, p2) == "reject", (point_field, comp)
        assert ref_verdict(smoke, p2) == "reject", (point_field, comp)


# ---------------------------------------------------------------------------
# the non-canonical limb forge and the bit-decomposition alias
# ---------------------------------------------------------------------------

def _forged(ic, fw, commit, dc, safa, monkeypatch):
    """`fw.run_prover` with every nonnative witness value that fits
    encoded as limbs of v + p (`ic.nn_witness` patched, as the
    reference's test patches it); the exception's type name where the
    prover fails."""
    honest = ic.nn_witness

    def malicious(name, v):
        for M in (F.P, F.Q):
            if v < M and v + M < (1 << 255):
                return honest(name, v + M)
        return honest(name, v)

    with monkeypatch.context() as m:
        m.setattr(ic, "nn_witness", malicious)
        try:
            return fw.run_prover(commit, dc, safa, CODES, batch_size=BATCH)
        except Exception as e:
            return type(e).__name__


def test_noncanonical_limb_forge_rejected_by_both(smoke, monkeypatch):
    """The port's prover fails as the reference's does, or both
    verifiers reject its proof."""
    commit, dc = FW.run_committer(CODES, smoke.safa.ab, False, seed=6)
    proofs = _forged(IC, FW, commit, dc, smoke.safa, monkeypatch)
    if isinstance(proofs, str):   # the attack died inside the prover
        rc, rdc = ref_fw.run_committer(CODES, smoke.ref_safa.ab, False,
                                       seed=6)
        assert _forged(ref_ic, ref_fw, rc, rdc, smoke.ref_safa,
                       monkeypatch) == proofs
        return
    ref_commit = ref_sz.loads(sz.dumps("cmt", commit), "cmt")
    assert port_verdict(smoke, proofs, commit) == "reject"
    assert ref_verdict(smoke, proofs, ref_commit) == "reject"


def _alias(ic, r1, f, v):
    """The reference test's alias on one package: the constraint count,
    whether the honest and the aliased assignments satisfy the
    truncation, and both outputs."""
    p = f.p
    cs = r1.ConstraintSystem(f)
    x = cs.input("x")
    low, _ = ic.truncate(cs, x, ic.HASH_BITS, "t")
    out = cs.aux("out", lambda z: cs.eval_lc(low, z))
    cs.enforce_eq(out, low)
    circ = r1.CompiledCircuit(cs)
    wires = circ.witness({"x": v})
    honest_ok = circ.check_all(wires) is None
    alias = v + p
    forged = list(wires)
    for j in range(255):
        forged[cs.names[f"t_b{j}"]] = (alias >> j) & 1
    forged[cs.names["out"]] = alias % (1 << ic.HASH_BITS) % p
    return (len(wires), len(cs.names), honest_ok,
            circ.check_all(forged) is None, wires[cs.names["out"]],
            forged[cs.names["out"]])


def test_bit_decomposition_alias_as_in_reference():
    """For x with x + p < 2^255 the 255-bit decomposition admits the
    bits of x + p: the alias satisfies the constraints and changes the
    truncated output, in the port exactly as in the reference."""
    v = 0x1234 + (1 << 253)
    assert v + F.FQ.p < (1 << 255)
    got = _alias(IC, r1cs, F.FQ, v)
    want = _alias(ref_ic, ref_r1cs, ref_field.FQ, v)
    assert got == want
    _, _, honest_ok, alias_ok, honest_out, forged_out = got
    assert honest_ok and alias_ok, "the circuit does not admit the alias"
    assert forged_out != honest_out, "the alias is output-invisible"


# ---------------------------------------------------------------------------
# byte-level tampering of the files
# ---------------------------------------------------------------------------

def _tampered(data: bytes, seed: int):
    """(label, bytes): FLIPS single-byte flips with the checksum left
    as it is, FLIPS with the checksum made good, and two truncations."""
    rng = random.Random(seed)
    out = []
    for k in range(2 * FLIPS):
        pos = rng.randrange(len(data) - 16)
        b = bytearray(data)
        b[pos] ^= 1 << rng.randrange(8)
        out.append((f"flip@{pos}", bytes(b)) if k < FLIPS
                   else (f"resealed flip@{pos}", _resealed(bytes(b))))
    out += [("truncated by 1", data[:-1]),
            ("truncated by half", data[:len(data) // 2])]
    return out


def _file_verdict(loads, verify, verify_error, kind, data) -> str:
    try:
        obj = loads(data, kind)
    except verify_error:
        return "refused by the loader"
    return _verdict(lambda: verify(obj), verify_error)


@pytest.mark.parametrize("kind", ["cmt", "proof"])
def test_tampered_file_refused_by_both(smoke, kind):
    honest = {"cmt": (smoke.commit, smoke.proofs),
              "proof": (smoke.proofs, smoke.commit)}
    data = sz.dumps(kind, honest[kind][0])
    ref_proofs = ref_sz.loads(sz.dumps("proof", smoke.proofs), "proof")

    def port_verify(obj):
        commit, proofs = ((obj, smoke.proofs) if kind == "cmt"
                          else (smoke.commit, obj))
        return FW.run_verifier(commit, smoke.safa, proofs, batch_size=BATCH)

    def ref_verify(obj):
        commit, proofs = ((obj, ref_proofs) if kind == "cmt"
                          else (smoke.ref_commit, obj))
        return ref_fw.run_verifier(commit, smoke.ref_safa, proofs,
                                   batch_size=BATCH)

    cases = _tampered(data, {"cmt": 7, "proof": 8}[kind])
    for label, bad in cases:
        assert bad != data
        port = _file_verdict(sz.loads, port_verify, errors.VerifyError,
                             kind, bad)
        ref = _file_verdict(ref_sz.loads, ref_verify, ref_errors.VerifyError,
                            kind, bad)
        assert port != "accept" and ref != "accept", (kind, label)
        assert port == ref, (kind, label, port, ref)


@pytest.mark.parametrize("kind", ["cmt", "proof"])
def test_tampered_file_refused_by_both_clis(monkeypatch, tmp_path, capsys,
                                            kind):
    """The port's CLI commits and proves; each package's `--verify`
    refuses the same tampered file alike: an error line (the loader) or
    `Verification FAILED`, exit code 1, never a traceback."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "doc.txt").write_text(DOC)
    files = ["--cmt-name", "doc.cmt", "--proof-name", "doc.proof"]
    argv = ["ascii", "-d", "doc.txt", "-r", REGEX, "-b", str(BATCH), *files]
    port = argv + ["--device", "cpu"]
    for mode in ("--commit", "--prove"):
        run_cli(cli.main, port[:1] + [mode] + port[1:])
    path = tmp_path / f"doc.{kind}"
    data = path.read_bytes()
    fresh_reference_terms()
    for label, bad in _tampered(data, {"cmt": 17, "proof": 18}[kind])[::4]:
        path.write_bytes(bad)
        got = _cli_verdict(cli.main, port[:1] + ["--verify"] + port[1:],
                           capsys)
        want = _cli_verdict(ref_cli.main, argv[:1] + ["--verify"] + argv[1:],
                            capsys)
        assert got != "passed" and got == want, (kind, label, got, want)
    path.write_bytes(data)
    assert _cli_verdict(cli.main, port[:1] + ["--verify"] + port[1:],
                        capsys) == "passed"
