"""The IPA prover's device round engine (ec/ipa_device.py, csrc/ipa.cu)
on the card: its kernels exactly against their plain versions, each
launch counted, at the compressed SNARK's two proofs' lengths (Pallas
2^16, Vesta 2^14) with the combine on the window sums of a real round;
its rounds bit for bit against the native host engine over the resident
bases of those proofs; and a Spartan proof made with it verified.

The plain versions are held to the JAX package's host engine on the CPU
by tests/test_torch_ipa_device.py; this file imports neither JAX nor the
JAX package (the card lane, `pytest --noconftest -m cuda
tests/test_torch_card_*.py`).
"""

import random

import pytest
import torch

from reef_tpu_torch.backend import commitment as CM
from reef_tpu_torch.backend import routes
from reef_tpu_torch.ec import ipa_device as D
from reef_tpu_torch.ec import msm, msm_v3
from reef_tpu_torch.ec.native_msm import IpaNative
from reef_tpu_torch.ec.pasta import PALLAS, VESTA
from reef_tpu_torch.utils import cudabuild

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _table(sf, n, seed):
    rng = random.Random(seed)
    return D._table([rng.randrange(sf.p_int) for _ in range(n)], sf.p_int,
                    "cpu")


def _dot_sums(sf, part):
    """The two dots of (2, 8, blocks) partials, as ints mod p."""
    from reef_tpu_torch.ops import limb
    words = part.cpu().permute(0, 2, 1).reshape(-1, limb.N32).numpy()
    ints = limb._words_to_ints(words, 32)
    nb = part.shape[2]
    return [sum(ints[k * nb:(k + 1) * nb]) % sf.p_int for k in (0, 1)]


# the compressed SNARK's two proofs: (curve, log2 n)
MAIN_PATH = [(PALLAS, 16), (VESTA, 14)]
MAIN_IDS = ["pallas-16", "vesta-14"]


@pytest.mark.parametrize("cv,log_n", MAIN_PATH, ids=MAIN_IDS)
def test_ipa_kernels_match_plain_on_card(cv, log_n):
    """The four kernels against their plain versions (on the CPU) at the
    main path's length, in the first round, a middle one and the last;
    the combine on the window sums that msm_windows gives for the round's
    own scalars over the resident basis."""
    _need_card()
    sf, ck, dev = D.scalar_field(cv), msm.kernels_for(cv), "cuda"
    n_orig = 1 << log_n
    basis = CM.PedersenGens(cv, b"reef/g/pv", n_orig).device_G()
    w, R, coeff = (_table(sf, n_orig, s) for s in (1, 2, 3))
    rng = random.Random(4)
    before = cudabuild.launch_counts()
    ns = (n_orig, 1 << 9, 2)
    for n in ns:
        out_k = torch.zeros((basis.n2, 64), dtype=torch.uint8, device=dev)
        out_p = torch.zeros((basis.n2, 64), dtype=torch.uint8)
        D.scalars(sf, w.to(dev), coeff.to(dev), n, out_k)
        D.scalars_plain(sf, w, coeff, n, out_p)
        assert torch.equal(out_k.cpu(), out_p), n
        part_k = D.dots(sf, w.to(dev), R.to(dev), n // 2)
        part_p = D.dots_plain(sf, w, R, n // 2)
        assert _dot_sums(sf, part_k) == _dot_sums(sf, part_p), n
        if n != ns[1]:          # the plain combine takes a second
            accs = msm_v3.msm_windows(ck, basis, out_k)
            got = D.combine(ck, sf, accs, D.ROWS, part_k).cpu()
            assert torch.equal(got, D.combine_plain(
                ck, sf, accs.cpu(), D.ROWS, part_p)), n
        x = rng.randrange(1, sf.p_int)
        xm, xim = sf.mont(x), sf.mont(pow(x, -1, sf.p_int))
        wp, Rp, cp = w.clone(), R.clone(), coeff.clone()
        D.fold_plain(sf, wp, Rp, cp, n, xm, xim)
        wk, Rk, ck_ = w.to(dev), R.to(dev), coeff.to(dev)
        D.fold(sf, wk, Rk, ck_, n, xm, xim)
        assert torch.equal(wk.cpu(), wp) and torch.equal(Rk.cpu(), Rp)
        assert torch.equal(ck_.cpu(), cp)
    torch.cuda.synchronize()
    after = cudabuild.launch_counts()
    for k in ("ipa_scalars", "ipa_dots", "ipa_fold"):
        assert after[k] == before[k] + len(ns), k
    assert after["ipa_combine"] == before["ipa_combine"] + 2


@pytest.mark.parametrize("cv,log_n", MAIN_PATH, ids=MAIN_IDS)
def test_device_rounds_equal_host_on_card(cv, log_n):
    """Every round over the basis the fold steps' commits upload
    (`reef/g/pv`), against the native host engine."""
    _need_card()
    n = 1 << log_n
    gens = CM.PedersenGens(cv, b"reef/g/pv", n)
    rng = random.Random(log_n)
    p = cv.order
    w = [rng.randrange(p) for _ in range(n)]
    R = [rng.randrange(p) for _ in range(n)]
    xs = [rng.randrange(1, p) for _ in range(log_n)]
    engines = [D.IpaDevice(gens, w, R),
               IpaNative(cv, w, R, bytes(gens.packed_G()))]
    before = cudabuild.launch_counts()
    for x in xs:
        a, b = (e.cross() for e in engines)
        assert a == b
        for e in engines:
            e.fold(x)
    assert engines[0].final() == engines[1].final()
    for e in engines:
        e.close()
    after = cudabuild.launch_counts()
    for k in ("ipa_scalars", "ipa_dots", "ipa_combine", "ipa_fold"):
        assert after[k] == before[k] + log_n, k


def test_spartan_with_device_ipa_verifies(monkeypatch):
    """A folded chain of a small circuit compressed by spartan_prove with
    the batched opening's IPA on the device engine."""
    _need_card()
    from reef_tpu_torch.backend.nova import (FoldingProver, R1CSShape,
                                             VectorCommitter)
    from reef_tpu_torch.backend.r1cs import (CompiledCircuit,
                                             ConstraintSystem, lc_add,
                                             lc_const)
    from reef_tpu_torch.backend.spartan import spartan_prove, spartan_verify
    from reef_tpu_torch.ops import field as F
    cs = ConstraintSystem(F.FQ)
    x_in, a = cs.input("x_in"), cs.input("a")
    x_sq, ax = cs.mul(x_in, x_in, "x_sq"), cs.mul(a, x_in, "ax")
    x_out = cs.input("x_out")
    cs.enforce_eq(x_out, lc_add(x_sq, ax, lc_const(7)))
    cs.mul(cs.mul(x_sq, ax, "b"), x_sq, "c")
    circ = CompiledCircuit(cs)
    shape = R1CSShape(circ, ["x_in", "x_out"])
    wc, ec = VectorCommitter(shape.w_pad), VectorCommitter(shape.n_cons)
    prover = FoldingProver(shape, wc, ec)
    x = 3
    for av in (5, 11):
        out = (x * x + av * x + 7) % F.FQ.p
        prover.fold_step(circ.witness({"x_in": x, "a": av, "x_out": out}))
        x = out
    before = cudabuild.launch_counts()["ipa_combine"]
    with routes.use(routes.Policy(ipa=2)):
        proof = spartan_prove(shape, wc, ec, prover.U, prover.Wit)
    assert cudabuild.launch_counts()["ipa_combine"] > before
    assert spartan_verify(shape, wc, ec, prover.U, proof)
