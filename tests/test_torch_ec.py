"""reef_tpu_torch curve layer against the JAX package and python ints.

The port's plain complete addition (ec/msm.py, ec/padd.py) must give the
same canonical projective coordinates as the JAX package's `ec.msm.padd`
and as the TPU kernel's body, `ec.pallas_ec.padd_tiles` /
`padd_affine_tiles`, called as plain jnp (Mosaic's interpret mode is too
slow for that kernel on the CPU).  The cases include the identity,
doubling and P + (-P), as tests/test_pallas_ec.py does.  Tests marked
`cuda` hold the CUDA kernels against their plain versions and skip where
torch sees no CUDA device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu.ec import msm as ref_msm
from reef_tpu.ec import pallas_ec as ref_pe
from reef_tpu_torch import convert
from reef_tpu_torch.backend.commitment import PedersenGens
from reef_tpu_torch.ec import msm, msm_v3
from reef_tpu_torch.ec.padd import (limb_join, limb_split, padd_soa,
                                    padd_soa_plain)
from reef_tpu_torch.utils import cudabuild

CURVES = {
    "pallas": (msm.pallas_kernels, ref_msm.pallas_kernels),
    "vesta": (msm.vesta_kernels, ref_msm.vesta_kernels),
}

_ref_padd = ref_msm.padd        # eager: its jit compiles for ~35 s here


def _pairs(cv, seed: int):
    """Random pairs plus the identity, doubling and P + (-P) cases."""
    rng = np.random.default_rng(seed)
    mults = [int(v) for v in rng.integers(1, 1 << 40, size=8)]
    pts = [cv.mul(k, cv.gen) for k in mults]
    g5 = cv.mul(5, cv.gen)
    pairs = list(zip(pts[:4], pts[4:]))
    pairs += [(None, cv.gen), (g5, g5), (g5, cv.neg(g5)), (None, None),
              (cv.gen, None)]
    return pairs


def _soa(ck, pts) -> torch.Tensor:
    """Affine host points -> (3, 8, n) int32 Montgomery projective."""
    return torch.from_numpy(ck.to_proj(pts)).permute(1, 2, 0).contiguous()


def _to_ref(t: torch.Tensor) -> np.ndarray:
    """Port (3, 8, n) int32 -> reference (n, 3, 16) uint32 points."""
    return np.ascontiguousarray(
        np.transpose(convert.limbs32_to_16(t.numpy(), axis=1), (2, 0, 1)))


@pytest.mark.parametrize("name", sorted(CURVES))
def test_padd_matches_reference_and_curve(name):
    ck, rck = CURVES[name][0](), CURVES[name][1]()
    cv = ck.curve
    pairs = _pairs(cv, 11)
    P = _soa(ck, [a for a, _ in pairs])
    Q = _soa(ck, [b for _, b in pairs])
    # projective inputs with Z != 1 as well: sums of the affine ones
    P2 = padd_soa(ck, P, Q)
    Q2 = padd_soa(ck, Q, padd_soa(ck, P, P))
    for A, B in ((P, Q), (P2, Q2)):
        got = padd_soa(ck, A, B)
        assert torch.equal(got, padd_soa_plain(ck, A, B))
        want = _ref_padd(rck, jnp.asarray(_to_ref(A)),
                         jnp.asarray(_to_ref(B)))
        np.testing.assert_array_equal(_to_ref(got), np.asarray(want))
        aff = lambda T: ck.to_affine(T.permute(2, 0, 1))
        assert aff(got) == [cv.add(a, b) for a, b in zip(aff(A), aff(B))]
    assert ck.to_affine(P2[:, :, 6]) is None          # P + (-P)
    assert ck.to_affine(P2[:, :, 5]) == cv.mul(10, cv.gen)


@pytest.mark.parametrize("name", ["pallas", "vesta"])
def test_padd_matches_kernel_body(name):
    """The TPU kernel's body, padd_tiles / padd_affine_tiles, as jnp."""
    ck, rck = CURVES[name][0](), CURVES[name][1]()
    cv = ck.curve
    pairs = _pairs(cv, 12)
    P = _soa(ck, [a for a, _ in pairs])
    Q = _soa(ck, [b for _, b in pairs])
    P = padd_soa(ck, P, Q)                            # Z != 1
    limbs = lambda T, c: [jnp.asarray(a) for a in
                          convert.limbs32_to_16(T.numpy(), axis=1)[c]]
    X3, Y3, Z3 = ref_pe.padd_tiles(rck, *(limbs(P, c) for c in range(3)),
                                   *(limbs(Q, c) for c in range(3)))
    want = np.stack([np.stack([np.asarray(v) for v in co])
                     for co in (X3, Y3, Z3)])         # (3, 16, n)
    got = padd_soa(ck, P, Q)
    np.testing.assert_array_equal(
        convert.limbs32_to_16(got.numpy(), axis=1), want)

    # Z = 1 operands only: the 10-product affine add of tree level 1
    aff = [(a, b) for a, b in pairs if a is not None and b is not None]
    A = _soa(ck, [a for a, _ in aff])[:2].contiguous()
    B = _soa(ck, [b for _, b in aff])[:2].contiguous()
    X3, Y3, Z3 = ref_pe.padd_affine_tiles(
        rck, *(limbs(A, c) for c in range(2)), *(limbs(B, c) for c in range(2)))
    want = np.stack([np.stack([np.asarray(v) for v in co])
                     for co in (X3, Y3, Z3)])
    got = limb_join(msm.padd_affine(ck, limb_split(A), limb_split(B)))
    np.testing.assert_array_equal(
        convert.limbs32_to_16(got.numpy(), axis=1), want)
    assert ck.to_affine(got.permute(2, 0, 1)) == [cv.add(a, b)
                                                  for a, b in aff]


def test_padd_soa_checks_its_inputs():
    ck = msm.vesta_kernels()
    P = _soa(ck, [ck.curve.gen] * 4)
    with pytest.raises(TypeError):
        padd_soa(ck, P.long(), P.long())
    with pytest.raises(ValueError):
        padd_soa(ck, P[:2].contiguous(), P[:2].contiguous())
    with pytest.raises(ValueError):
        padd_soa(ck, P[:, :, ::2], P[:, :, ::2])
    with pytest.raises(ValueError):
        padd_soa(ck, P, P[:, :, :2].contiguous())


@pytest.mark.parametrize("name", sorted(CURVES))
def test_tree_levels_plain_sums_sorted_points(name):
    """Node k of level b is the sum of points [k 2^b, (k+1) 2^b)."""
    ck = CURVES[name][0]()
    cv = ck.curve
    W, cap = 3, 16
    rng = np.random.default_rng(13)
    pts = [cv.mul(int(k), cv.gen) for k in rng.integers(1, 1 << 30, cap)]
    base = _soa(ck, pts)
    order = torch.from_numpy(
        np.stack([rng.permutation(cap) for _ in range(W)]))
    placed = base[:2][:, :, order].contiguous()          # (2, 8, W, cap)
    out = msm_v3.tree_levels(ck, placed)
    assert torch.equal(out, msm_v3.tree_levels_plain(ck, placed))
    offs = msm_v3.level_offsets(cap)
    for w in range(W):
        seq = [pts[i] for i in order[w].tolist()]
        for b in range(1, len(offs)):
            for k in range(cap >> b):
                total = None
                for pt in seq[k << b:(k + 1) << b]:
                    total = cv.add(total, pt)
                node = ck.to_affine(out[:, :, w, offs[b] + k])
                assert node == total, (w, b, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CURVES))
def test_kernels_match_plain_on_card(name):
    """K1 (csrc/padd.cu) and K2 (csrc/msm_tree.cu, at cap 4096 and 16384)
    on the card, exactly against their plain versions, each launch
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ck = CURVES[name][0]()
    cv = ck.curve
    dev = torch.device("cuda")
    pairs = _pairs(cv, 14) * 300
    P = _soa(ck, [a for a, _ in pairs]).to(dev)
    Q = _soa(ck, [b for _, b in pairs]).to(dev)
    before = cudabuild.launch_counts()["padd"]
    got = padd_soa(ck, P, Q)
    assert torch.equal(got.cpu(), padd_soa_plain(ck, P.cpu(), Q.cpu()))
    assert cudabuild.launch_counts()["padd"] == before + 1
    g = torch.Generator().manual_seed(15)
    for cap in (4096, 16384):
        W = 32
        order = torch.stack([torch.randperm(cap, generator=g)
                             for _ in range(W)])
        base = _soa(ck, PedersenGens(cv, b"test_torch_ec/tree", cap).G)
        placed = base[:2][:, :, order].contiguous().to(dev)
        before = cudabuild.launch_counts()["msm_tree"]
        tree = msm_v3.tree_levels(ck, placed)
        torch.cuda.synchronize()
        assert torch.equal(tree[..., :cap - 1],
                           msm_v3.tree_levels_plain(ck, placed)[..., :cap - 1])
        assert cudabuild.launch_counts()["msm_tree"] == \
            before + len(msm_v3.tree_plan(cap))
