"""reef_tpu_torch curve layer against the JAX package and python ints.

The port's plain complete addition (ec/msm.py, ec/padd.py) must give the
same canonical projective coordinates as the JAX package's `ec.msm.padd`
and as the TPU kernel's body, `ec.pallas_ec.padd_tiles` /
`padd_affine_tiles`, called as plain jnp (Mosaic's interpret mode is too
slow for that kernel on the CPU).  The cases include the identity,
doubling and P + (-P), as tests/test_pallas_ec.py does.  The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_card_ec.py, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_card_support import pairs as _pairs
from _torch_card_support import soa as _soa
from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread, stand_in_card)
from reef_tpu.ec import msm as ref_msm
from reef_tpu.ec import pallas_ec as ref_pe
from reef_tpu_torch import convert
from reef_tpu_torch.ec import msm, msm_v3
from reef_tpu_torch.ec import padd as PD
from reef_tpu_torch.ec.padd import (limb_join, limb_split, padd_soa,
                                    padd_soa_plain)
from reef_tpu_torch.utils import cudabuild

CURVES = {
    "pallas": (msm.pallas_kernels, ref_msm.pallas_kernels),
    "vesta": (msm.vesta_kernels, ref_msm.vesta_kernels),
}

_ref_padd = ref_msm.padd        # eager: its jit compiles for ~35 s here


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


@pytest.mark.parametrize("B", [1, PD.THREAD_MIN_B - 1, PD.THREAD_MIN_B,
                               PD.THREAD_MIN_B + 1])
def test_padd_soa_routes_by_batch_and_path(B, monkeypatch, stand_in_card):
    """`route` sends batches below THREAD_MIN_B to SPREAD; `launch` hands
    the library the path it is given and counts `padd`, and `padd_spread`
    for SPREAD (a stand-in library records the call; nothing launches);
    `padd_soa` refuses an unknown path, and on the CPU gives the plain
    sums whichever path it is asked for."""
    want = PD.SPREAD if B < PD.THREAD_MIN_B else PD.THREAD
    assert PD.route(B) == want
    calls = []

    class Lib:
        def reef_padd(self, p, q, o, b, field, path, stream):
            assert stand_in_card.current == P.device
            calls.append((b, field, path))
            return 0

    monkeypatch.setattr(PD.cudabuild, "library", lambda name: Lib())
    ck = msm.pallas_kernels()
    P = torch.zeros((3, 8, B), dtype=torch.int32)
    for path in (PD.THREAD, PD.SPREAD):
        before = cudabuild.launch_counts()
        PD.launch(ck, P, P, path)
        after = cudabuild.launch_counts()
        assert calls[-1] == (B, ck.lf.field_id, path)
        assert after["padd"] == before["padd"] + 1
        assert after["padd_spread"] == before["padd_spread"] + \
            (path == PD.SPREAD)
    with pytest.raises(ValueError):
        PD.launch(ck, P, P, 2)
    with pytest.raises(ValueError):
        padd_soa(ck, P, P, path=2)
    pairs = _pairs(ck.curve, 16)
    A = _soa(ck, [a for a, _ in pairs])
    Bq = _soa(ck, [b for _, b in pairs])
    for path in (None, PD.THREAD, PD.SPREAD):
        assert torch.equal(padd_soa(ck, A, Bq, path=path),
                           padd_soa_plain(ck, A, Bq))


def _ref_level_loop(rck, X, acc):
    """The reference MSM's halving (reef_tpu/ec/msm_v3.py, the Fenwick
    levels and `_halve_digits`) with the JAX package's point add: level by
    level, point j plus point j + L/2, then acc + the sum."""
    def add(A, B):
        s = _ref_padd(rck, jnp.asarray(_to_ref(A.reshape(3, 8, -1)
                                               .contiguous())),
                      jnp.asarray(_to_ref(B.reshape(3, 8, -1).contiguous())))
        return limb_join(convert.points_from_reference(np.asarray(s))
                         ).reshape(A.shape)
    L = X.shape[3]
    while L > 1:
        L //= 2
        X = add(X[..., :L, :], X[..., L:, :])
    return X[..., 0, :] if acc is None else add(acc, X[..., 0, :])


def _reduce_input(ck, A, L, C, seed):
    """(3, 8, A, L, C) projective points with Z != 1 and identities, and
    acc (3, 8, A, C); with the affine points they stand for."""
    cv = ck.curve
    rng = np.random.default_rng(seed)
    n = A * L * C
    pts = [cv.mul(int(k), cv.gen) for k in rng.integers(1, 1 << 30, n)]
    pts[1] = None
    X = _soa(ck, pts)
    X = padd_soa(ck, X, X.roll(1, 2).contiguous())     # Z != 1
    aff = ck.to_affine(X.permute(2, 0, 1))
    acc_pts = [cv.mul(int(k), cv.gen) for k in rng.integers(1, 1 << 30,
                                                               A * C)]
    acc = _soa(ck, acc_pts).reshape(3, 8, A, C).contiguous()
    return X.reshape(3, 8, A, L, C).contiguous(), aff, acc, acc_pts


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("A,L,C,with_acc", [(2, 8, 3, True), (2, 16, 1, False),
                                            (1, 2, 4, True), (3, 4, 2, False)])
def test_padd_reduce_matches_level_loop(name, A, L, C, with_acc):
    """padd_reduce (its plain version, on the CPU) gives the limbs of the
    reference's per-level loop over the JAX package's point add exactly,
    and the sum of each output's points (plus acc) on the curve."""
    ck, rck = CURVES[name][0](), CURVES[name][1]()
    cv = ck.curve
    X, aff, acc, acc_pts = _reduce_input(ck, A, L, C, 17)
    acc = acc if with_acc else None
    got = PD.padd_reduce(ck, X, acc)
    assert got.shape == (3, 8, A, C)
    assert torch.equal(got, _ref_level_loop(rck, X, acc))
    for a in range(A):
        for c in range(C):
            total = acc_pts[a * C + c] if with_acc else None
            for j in range(L):
                total = cv.add(total, aff[(a * L + j) * C + c])
            assert ck.to_affine(got[:, :, a, c]) == total


def _emulate_reduce(ck, X, args):
    """csrc/padd.cu's reduce kernel on the CPU from the arguments the
    wrapper hands it: its lane arithmetic over X's storage, its levels,
    its shared-memory slots and its acc add, with the plain add."""
    (row, n_out, inner, s_hi, s_lo, s_l, L, acc, gpb, threads,
     mask) = args
    flat = torch.as_strided(X, (X.untyped_storage().nbytes() // 4
                                - X.storage_offset(),), (1,),
                            X.storage_offset())
    assert threads <= PD.REDUCE_MAX_THREADS and (
        mask == 0 or threads >= PD.SPREAD_THREADS)

    def point(lane):
        return flat[torch.arange(24) * row + lane].reshape(3, 8, 1)

    def add(p, q):
        return padd_soa_plain(ck, p.contiguous(), q.contiguous())

    out = torch.zeros((3, 8, n_out), dtype=torch.int32)
    half = L // 2
    for blk in range(-(-n_out // gpb)):
        pts = {}
        h = half
        levels = (L.bit_length() - 1) + (acc is not None)
        for lev in range(levels):
            acc_add = acc is not None and lev == levels - 1
            adds = gpb * (1 if acc_add else h)
            for a in range(adds):
                lg, k = a % gpb, a // gpb
                o = blk * gpb + lg
                if o >= n_out:
                    continue
                if acc_add:
                    r = add(acc.reshape(3, 8, -1)[:, :, o:o + 1], pts[lg])
                elif lev == 0:
                    lane = (o // inner) * s_hi + (o % inner) * s_lo
                    r = add(point(lane + k * s_l), point(lane + (k + h) * s_l))
                else:
                    r = add(pts[k * gpb + lg], pts[(k + h) * gpb + lg])
                if lev == levels - 1:
                    out[:, :, o] = r[:, :, 0]
                else:
                    pts[k * gpb + lg] = r
            h = max(1, h // 2)
    return out


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("view", ["fenwick", "digits", "strided"])
def test_padd_reduce_launch_addresses_its_points(name, view, monkeypatch,
                                                 stand_in_card):
    """The arguments padd_reduce hands the library (strides, plan, acc),
    run through an emulation of the kernel's indexing, give the plain
    sums: the Fenwick shape (levels x digits, with acc), the digit axis of
    a (3, 8, W, DP) array seen as (3, 8, W, DP, 1), and a strided view."""
    ck = CURVES[name][0]()
    X, _, acc, _ = _reduce_input(ck, 2, 8, 4, 18)
    if view == "digits":
        X, acc = X[:, :, :, :, 0].contiguous()[..., None], None
    elif view == "strided":
        X, acc = X[:, :, :, :4, 1:3], None
    calls = []

    class Lib:
        def reef_padd_reduce(self, x, row, n_out, inner, s_hi, s_lo, s_l, L,
                             acc_p, out, gpb, threads, mask, field, stream):
            assert x == X.data_ptr() and field == ck.lf.field_id
            assert stand_in_card.current == X.device
            assert acc_p == (0 if acc is None else acc.data_ptr())
            calls.append((row, n_out, inner, s_hi, s_lo, s_l, L, acc, gpb,
                          threads, mask))
            return 0

    monkeypatch.setattr(PD.cudabuild, "library", lambda name: Lib())
    monkeypatch.setattr(PD.cudabuild, "on_card", lambda name, t: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("Props", (), {
                            "multi_processor_count": 132}))
    before = cudabuild.launch_counts()
    PD.padd_reduce(ck, X, acc)
    after = cudabuild.launch_counts()
    assert len(calls) == 1
    assert after["padd_reduce"] == before["padd_reduce"] + 1
    assert after["padd"] == before["padd"] + 1
    want = PD.padd_reduce_plain(ck, X, acc)
    got = _emulate_reduce(ck, X, calls[0])
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("n_out,L,acc", [(8192, 16, True), (32, 256, False),
                                         (1, 2, False), (3, 4, True),
                                         (4096, 256, True), (100000, 2,
                                                             False)])
def test_reduce_plan_fits_the_card(n_out, L, acc):
    """The plan of a reduce: SPREAD exactly at the levels whose adds over
    the grid are under THREAD_MIN_B; threads within the kernel's bounds
    and, at a SPREAD level, six a group; outputs a block for 128
    first-level adds; shared memory within 48 KB.  On an H100's 132
    SMs."""
    sms = 132
    gpb, threads, mask = PD.reduce_plan(n_out, L, acc, sms)
    half = L // 2
    adds = [n_out * (half >> lev) for lev in range(L.bit_length() - 1)]
    adds += [n_out] if acc else []
    assert mask == sum(1 << i for i, n in enumerate(adds)
                       if n < PD.THREAD_MIN_B)
    assert gpb * half == max(128, half)
    assert 128 <= threads <= PD.REDUCE_MAX_THREADS and threads % 32 == 0
    if -(-n_out // gpb) >= sms or not mask:
        assert threads == 128
    shmem = gpb * half * 96 + threads // 6 * 12 * 32
    assert shmem <= 48 * 1024


def test_padd_reduce_checks_its_inputs():
    ck = msm.pallas_kernels()
    X = torch.zeros((3, 8, 2, 4, 3), dtype=torch.int32)
    acc = torch.zeros((3, 8, 2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        PD.padd_reduce(ck, X.long())
    with pytest.raises(ValueError):
        PD.padd_reduce(ck, X[:, :, :, :3])               # L = 3
    with pytest.raises(ValueError):
        PD.padd_reduce(ck, X[:2])
    with pytest.raises(ValueError):
        PD.padd_reduce(ck, X, acc[..., :2].contiguous())
    with pytest.raises(ValueError):
        PD.padd_reduce(ck, torch.zeros((3, 8, 1, 512, 1), dtype=torch.int32))
    with pytest.raises(ValueError):                      # coordinate rows
        PD.padd_reduce(ck, X.transpose(0, 2).contiguous().transpose(0, 2))
