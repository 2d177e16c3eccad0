"""reef_tpu_torch's off-path MSMs against the JAX package and the python
curve.

The v2 Pippenger MSM (ec/msm_pippenger.py), the binary double-and-add
MSM (ec/msm.py `msm_device`) and the lane-parallel MSM over K1
(ec/padd.py `msm_pallas`) run their plain versions on the CPU.  Their
results are held, exactly, against the JAX package's python curve
(reef_tpu.ec.pasta), which is the oracle of the reference's own
slow-marked tests (its window kernels take minutes to compile on
XLA:CPU); the points come from that curve too.  The host prep
(digits, sort order, boundaries, Fenwick nodes) is numpy in both
packages and must be equal array for array; the reference's projective points and window combine
are fed the port's through `convert.points_{from,to}_reference`.
"""

import random

import numpy as np
import pytest
import torch

from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu.ec import msm as ref_msm
from reef_tpu.ec import msm_pippenger as ref_mp
from reef_tpu.ec.pasta import PALLAS, VESTA
from reef_tpu_torch import convert
from reef_tpu_torch.ec import msm, msm_pippenger as mp
from reef_tpu_torch.ec.padd import msm_pallas
from reef_tpu_torch.ops import field_kernel, limb
from reef_tpu_torch.utils import cudabuild

ORDER = PALLAS.order


def _host_msm(cv, scalars, pts):
    acc = None
    for s, p in zip(scalars, pts):
        acc = cv.add(acc, cv.mul(s, p))
    return acc


def _points(cv, rng, n):
    return [cv.mul(rng.randrange(1, cv.order), cv.gen) for _ in range(n)]


def _edge_scalars(rng, n):
    """Random scalars with 0, 1, order - 1 and a duplicate among them
    (the degenerate cases of the reference's tests)."""
    scs = [rng.randrange(0, ORDER) for _ in range(n)]
    for i, s in enumerate([0, 1, ORDER - 1][:n]):
        scs[i] = s
    if n > 4:
        scs[3] = scs[4]
    return scs


@pytest.mark.parametrize("n", [1, 13, 16])
def test_window_prep_matches_reference(n):
    scs = _edge_scalars(random.Random(5 + n), n)
    for got, want in ((mp.window_prep(scs, ORDER, n),
                       ref_mp.window_prep(scs, ORDER, n)),
                      (mp.window_prep_v2(scs, ORDER, n),
                       ref_mp.window_prep_v2(scs, ORDER, n))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(mp._digits_np(scs, ORDER),
                                  ref_mp._digits_np(scs, ORDER))


@pytest.mark.parametrize("n", [1, 2, 13])
def test_msm_device_matches_oracle(n):
    rng = random.Random(41 + n)
    ck = msm.pallas_kernels()
    pts = _points(PALLAS, rng, n)
    scs = _edge_scalars(rng, n)
    got = mp.msm_device(ck, scs, pts, device="cpu")
    assert got == _host_msm(PALLAS, scs, pts)


def test_msm_device_chunked(monkeypatch):
    """REEF_DEVICE_MSM_CHUNK = 4 splits a 16-point MSM into four kernel
    runs whose window points are added on the device."""
    monkeypatch.setenv("REEF_DEVICE_MSM_CHUNK", "4")
    assert mp.chunk_cap() == 4
    rng = random.Random(77)
    ck = msm.vesta_kernels()
    pts = _points(VESTA, rng, 16)
    scs = [rng.randrange(VESTA.order) for _ in range(16)]
    got = mp.msm_device(ck, scs, pts, device="cpu")
    assert got == _host_msm(VESTA, scs, pts)


def test_device_basis_from_reference_and_reuse():
    """One basis, uploaded from the reference's projective points, serves
    two scalar sets and a shorter one."""
    rng = random.Random(99)
    ck = msm.pallas_kernels()
    pts = _points(PALLAS, rng, 6)
    ref_pts = ref_msm.pallas_kernels().to_proj(pts)       # (6, 3, 16)
    plain = convert.points_from_reference(ref_pts)
    assert torch.equal(plain, ck.to_plain(pts))
    np.testing.assert_array_equal(convert.points_to_reference(plain),
                                  ref_pts)
    basis = mp.DeviceBasis(ck, plain)
    assert basis.arr.shape == (3, 16, 8) and basis.n2 == 8
    for _ in range(2):
        scs = [rng.randrange(ORDER) for _ in range(6)]
        assert mp.msm_device(ck, scs, basis) == _host_msm(PALLAS, scs, pts)
    scs = [rng.randrange(ORDER) for _ in range(4)]
    assert mp.msm_device(ck, scs, basis) == _host_msm(PALLAS, scs, pts[:4])
    with pytest.raises(ValueError):
        mp.msm_device(ck, [1] * 9, basis)


@pytest.mark.parametrize("v2", [True, False], ids=["tree", "prefix"])
def test_window_kernels_give_each_window_sum(v2):
    """Both window kernels give A_w = sum_i digit_w(s_i) P_i for every
    window, and the reference's window combine of the port's A_w (through
    `points_to_reference`) equals the port's."""
    rng = random.Random(11)
    ck = msm.pallas_kernels()
    n = 16
    pts = _points(PALLAS, rng, n)
    scs = _edge_scalars(rng, n)
    basis = mp.DeviceBasis(ck, pts, device="cpu")
    ident = ck.ident16("cpu")
    prep = (mp.window_prep_v2 if v2 else mp.window_prep)(scs, ORDER, n)
    kern = (mp.window_kernel_v2_fn if v2 else mp.window_kernel_fn)(ck, n)
    args = [torch.from_numpy(a).long() if a.dtype != bool
            else torch.from_numpy(a) for a in prep]
    accs = kern(basis.arr, *args, ident)
    assert accs.shape == (3, 16, mp.N_WINDOWS)
    digs = mp._digits_np(scs, ORDER)
    want = [_host_msm(PALLAS, [int(d) for d in digs[w]], pts)
            for w in range(mp.N_WINDOWS)]
    assert ck.plain_to_affine(accs) == want
    ref_accs = convert.points_to_reference(accs)          # (W, 3, 16)
    assert ref_mp.combine_windows(ref_msm.pallas_kernels(), ref_accs) \
        == mp.combine_windows(ck, accs) == _host_msm(PALLAS, scs, pts)


def test_binary_msm_device_and_tree_reduce():
    rng = random.Random(8)
    ck = msm.pallas_kernels()
    n = 8
    pts = _points(PALLAS, rng, 7) + [None]
    scs = [rng.randrange(1 << 12) for _ in range(n)]
    scs[0] = 0
    P = ck.to_plain(pts)
    assert ck.plain_to_affine(msm.tree_reduce(ck, P)[..., None]) == [
        _host_msm(PALLAS, [1] * n, pts)]
    mask = torch.tensor([True, False] * 4)
    ident = ck.ident16("cpu")[:, :, None].expand(3, 16, n)
    assert ck.plain_to_affine(msm.select_point(mask, P, ident)) == [
        p if i % 2 == 0 else None for i, p in enumerate(pts)]
    got = msm.msm_device(ck, scs[:7], P[..., :7], device="cpu")
    assert got.shape == (3, 16)
    assert ck.plain_to_affine(got[..., None]) == [
        _host_msm(PALLAS, scs[:7], pts[:7])]


def test_binary_msm_device_k1_route(monkeypatch):
    """On the card the binary MSM adds through K1 on its (3, 8, m) int32
    layout; that route, run here through padd_soa's plain version, gives
    the same sums."""
    real = msm._point_add
    monkeypatch.setattr(msm, "_point_add",
                        lambda ck, dev: real(ck, torch.device("cuda")))
    rng = random.Random(9)
    ck = msm.vesta_kernels()
    pts = _points(VESTA, rng, 8)
    assert ck.plain_to_affine(msm.tree_reduce(ck, ck.to_plain(pts))[
        ..., None]) == [_host_msm(VESTA, [1] * 8, pts)]
    s = rng.randrange(VESTA.order)
    got = msm.msm_device(ck, [s], ck.to_plain(pts[:1]))
    assert ck.plain_to_affine(got[..., None]) == [VESTA.mul(s, pts[0])]


@pytest.mark.parametrize("n", [8, 1030])
def test_msm_pallas_matches_oracle(n):
    """msm_pallas over padd_soa's plain version: one group of 1024 lanes,
    then two (the second padded with identities); short scalars cut the
    bit count."""
    rng = random.Random(n)
    ck = msm.vesta_kernels()
    pts, acc = [], VESTA.gen
    for _ in range(n):
        pts.append(acc)
        acc = VESTA.add(acc, VESTA.gen)
    scs = [rng.randrange(1 << (8 if n < 100 else 3)) for _ in range(n)]
    got = msm_pallas(ck, scs, pts, device="cpu")
    assert got.shape == (3, limb.N32) and got.dtype == torch.int32
    assert ck.to_affine(got) == _host_msm(VESTA, scs, pts)


def test_msm_device_restores_the_callers_hook(monkeypatch):
    """msm_device enables the field-kernel hook where it routes products
    to K3 and leaves the caller's limb.mul and limb.redc_cols as they
    were, also when it raises."""
    base = limb.mul, limb.redc_cols
    seen = []
    real_accs = mp._msm_accs

    def spy(*args):
        seen.append((limb.mul, limb.redc_cols))
        return real_accs(*args)

    monkeypatch.setattr(mp, "_routes_to_kernels", lambda dev: True)
    monkeypatch.setattr(mp, "_msm_accs", spy)
    ck = msm.pallas_kernels()
    rng = random.Random(3)
    pts = _points(PALLAS, rng, 2)
    scs = [5, 7]
    assert mp.msm_device(ck, scs, pts, device="cpu") == \
        _host_msm(PALLAS, scs, pts)
    assert seen == [(field_kernel._dispatching_mul, base[1])]
    assert (limb.mul, limb.redc_cols) == base

    with field_kernel.enabled(redc=True):        # the caller's own hook
        mp.msm_device(ck, scs, pts, device="cpu")
        hooked = (field_kernel._dispatching_mul,
                  field_kernel._dispatching_redc_cols)
        assert seen[-1] == hooked
        assert (limb.mul, limb.redc_cols) == hooked
    assert (limb.mul, limb.redc_cols) == base

    def boom(*args):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(mp, "_msm_accs", boom)
    with pytest.raises(RuntimeError):
        mp.msm_device(ck, scs, pts, device="cpu")
    assert (limb.mul, limb.redc_cols) == base


@pytest.mark.cuda
def test_msm_device_on_card_launches_k3():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = random.Random(12)
    ck = msm.pallas_kernels()
    n = 512
    pts = PALLAS.gens(b"test_torch_pippenger", n)
    scs = [rng.randrange(ORDER) for _ in range(n)]
    base = limb.mul
    before = cudabuild.launch_counts()["mont_mul"]
    got = mp.msm_device(ck, scs, pts, device="cuda")
    assert got == PALLAS.msm(scs, pts)
    assert cudabuild.launch_counts()["mont_mul"] > before
    assert limb.mul is base
