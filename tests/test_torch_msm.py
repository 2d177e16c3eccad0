"""reef_tpu_torch device MSM (ec/msm_v3.py) and its routing, on the CPU.

On CPU tensors the MSM runs the kernels' plain versions through the same
sort / count / gather / Fenwick glue that drives the kernels on the card,
with one halving reduce a chunk and one an MSM.
Its results must equal the JAX package's python-int and native host MSMs
exactly.  `convert.py` must carry the JAX package's device basis over to
the port's.
"""

import numpy as np
import pytest
import torch

from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread, stand_in_card)
from reef_tpu.ec import msm as ref_msm
from reef_tpu.ec import msm_v3 as ref_v3
from reef_tpu.ec import native_msm as ref_native
from reef_tpu.ec import pasta as ref_pasta
from reef_tpu_torch import cli, convert
from reef_tpu_torch.backend import commitment as CM
from reef_tpu_torch.backend import routes
from reef_tpu_torch.ec import msm, msm_v3
from reef_tpu_torch.ec.pasta import PALLAS
from reef_tpu_torch.utils import device

CURVES = {"pallas": (msm.pallas_kernels, ref_pasta.PALLAS),
          "vesta": (msm.vesta_kernels, ref_pasta.VESTA)}


def _points(cv, n: int, seed: int, distinct: int = 64):
    """n affine points: `distinct` random multiples of the generator,
    repeated (the python scalar multiplications dominate otherwise)."""
    rng = np.random.default_rng(seed)
    pts = [cv.mul(int(k), cv.gen) for k in rng.integers(1, 1 << 48, distinct)]
    return (pts * (n // distinct + 1))[:n]


def _scalars(cv, n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = rng.integers(0, 1 << 32, size=8, dtype=np.uint64)
        out.append(sum(int(w) << (32 * i) for i, w in enumerate(words))
                   % cv.order)
    return out


def _native(ref_cv, scalars, pts):
    return ref_native.msm_packed(ref_cv, scalars,
                                 ref_native.pack_points(pts))


@pytest.fixture
def cpu_engine(monkeypatch):
    monkeypatch.setattr(device, "_SELECTED", None)
    device.select("cpu")


@pytest.mark.parametrize("name", sorted(CURVES))
def test_msm_tree_path_matches_reference(name, cpu_engine):
    """cap = 4096 runs the tree path; n = 3000 pads the basis with
    zero-scalar generators; a zero scalar stays out of every bucket."""
    ck, ref_cv = CURVES[name][0](), CURVES[name][1]
    n, cap = 3000, 4096
    pts = _points(ck.curve, n, 21)
    scalars = _scalars(ck.curve, n, 22)
    scalars[0] = 0
    scalars[1] = ck.curve.order - 1
    basis = msm_v3.DeviceBasisV3(ck, pts, cap=cap)
    assert basis.all_z1 and basis.cap >= msm_v3.TREE_MIN_CAP
    assert (basis.n, basis.n2, basis.n_chunks) == (n, cap, 1)
    got = msm_v3.msm_device_v3(ck, scalars, basis)
    assert got == ref_cv.msm(scalars, pts)
    assert got == _native(ref_cv, scalars, pts)


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("cap,n", [(128, 200), (4096, 3000)])
def test_msm_sums_through_one_reduce_a_chunk(name, cap, n, cpu_engine):
    """msm_windows makes one padd_reduce call a chunk (its Fenwick levels,
    padded to a power of two, with the running prefixes as acc) and one
    over the digits, and its window sums give the reference's MSM (at
    cap 128 over two chunks, below the tree kernel's cap)."""
    from reef_tpu_torch.ec.padd import padd_reduce
    ck, ref_cv = CURVES[name][0](), CURVES[name][1]
    pts = _points(ck.curve, n, 23)
    scalars = _scalars(ck.curve, n, 24)
    basis = msm_v3.DeviceBasisV3(ck, pts, cap=cap)
    scb = msm_v3.upload_scalars(basis, [scalars])[0]
    calls = []

    def spy(c, X, acc=None):
        calls.append((tuple(X.shape), acc is not None))
        return padd_reduce(c, X, acc)

    accs = msm_v3.msm_windows(ck, basis, scb, reduce=spy)
    L = 1 << (cap.bit_length() - 1).bit_length()
    W, DP = msm_v3.N_WINDOWS, msm_v3.DP
    assert basis.n_chunks == (2 if cap == 128 else 1)
    assert calls == [((3, 8, W, L, DP), True)] * basis.n_chunks + \
        [((3, 8, W, DP, 1), False)]
    assert msm_v3.combine_windows(ck, accs) == ref_cv.msm(scalars, pts)


@pytest.mark.parametrize("log", range(1, 17))
def test_tree_plan_makes_every_level_once_in_order(log, monkeypatch,
                                                   stand_in_card):
    """K2's plan for cap = 2 .. 65536 makes levels 1..log2 cap, each once
    and in order, and `tree_launch` hands the library that run of levels
    in one call and counts one launch a level (a stand-in library records
    the call; nothing launches)."""
    cap = 1 << log
    plan = msm_v3.tree_plan(cap)
    assert plan == list(range(1, log + 1))
    calls = []

    class Lib:
        def reef_tree_levels(self, src, out, W, cap_, lo, hi, field, stream):
            assert stand_in_card.current == placed.device
            calls.append((W, cap_, lo, hi, field))
            return 0

    monkeypatch.setattr(msm_v3.cudabuild, "library", lambda name: Lib())
    ck = msm.pallas_kernels()
    placed = torch.zeros((2, 8, 1, cap), dtype=torch.int32)
    out = torch.zeros((3, 8, 1, cap), dtype=torch.int32)
    before = msm_v3.cudabuild.launch_counts()["msm_tree"]
    msm_v3.tree_launch(ck, placed, out, plan)
    assert calls == [(1, cap, 1, log, ck.lf.field_id)]
    assert msm_v3.cudabuild.launch_counts()["msm_tree"] == before + log
    bad = [[0] + plan, plan + [log + 1], plan[:1] * 2]
    if log > 1:
        bad.append(plan[::-1])
    for levels in bad:
        with pytest.raises(ValueError):
            msm_v3.tree_launch(ck, placed, out, levels)
    assert len(calls) == 1


def test_msm_rows_small_chunks(cpu_engine):
    """The rows entry point with its device combine, over chunks below
    the tree floor (one point add per level), two chunks per MSM, and a
    row shorter than the basis (the rest count as zero)."""
    ck, ref_cv = msm.vesta_kernels(), ref_pasta.VESTA
    n = 200
    pts = _points(ck.curve, n, 23)
    rows = [_scalars(ck.curve, n, 24), _scalars(ck.curve, 150, 25)]
    rows[1][:50] = [0] * 50
    basis = msm_v3.DeviceBasisV3(ck, pts, cap=128)
    assert (basis.n2, basis.cap, basis.n_chunks) == (256, 128, 2)
    got = msm_v3.msm_device_v3_rows(ck, rows, basis)
    assert got == [_native(ref_cv, rows[0], pts),
                   _native(ref_cv, rows[1], pts[:150])]


@pytest.mark.parametrize("name", sorted(CURVES))
def test_convert_basis_from_reference(name, cpu_engine):
    ck, ref_cv = CURVES[name][0](), CURVES[name][1]
    rck = ref_msm.pallas_kernels() if name == "pallas" \
        else ref_msm.vesta_kernels()
    pts = _points(ck.curve, 200, 26)
    ref_basis = ref_v3.DeviceBasisV3(rck, pts, cap=128)
    got = convert.basis_from_reference(ck, np.asarray(ref_basis.arr))
    want = msm_v3.DeviceBasisV3(ck, pts, cap=128)
    assert torch.equal(got.arr, want.arr)
    assert (got.n2, got.cap, got.n_chunks, got.all_z1) == \
        (want.n2, want.cap, want.n_chunks, want.all_z1)
    back = convert.limbs32_to_16(got.arr.numpy(), axis=2)
    np.testing.assert_array_equal(back, np.asarray(ref_basis.arr))
    scalars = _scalars(ck.curve, 200, 27)
    assert msm_v3.msm_device_v3(ck, scalars, got) == \
        _native(ref_cv, scalars, pts)


def test_commit_routes_to_device_msm(monkeypatch, cpu_engine):
    """With the device routes taken on the CPU, commit and commit_rows take
    the device MSM and give the host route's points."""
    n = routes.DEFAULT.msm
    gens = CM.PedersenGens(PALLAS, b"test_torch_msm/commit", n)
    values = _scalars(PALLAS, n, 28)
    flat = _scalars(PALLAS, n, 29)
    blinds = [5]

    host = gens.commit(values, 3)            # the CPU engine: the host
    host_rows = gens.commit_rows(flat, blinds)

    calls = []
    orig, orig_rows = msm_v3.msm_device_v3, msm_v3.msm_device_v3_rows
    monkeypatch.setattr(msm_v3, "msm_device_v3",
                        lambda *a: calls.append("one") or orig(*a))
    monkeypatch.setattr(msm_v3, "msm_device_v3_rows",
                        lambda *a: calls.append("rows") or orig_rows(*a))
    with routes.use(routes.Policy(cpu=True, rows=n)):
        assert gens.commit(values, 3) == host
        assert gens.commit_rows(flat, blinds) == host_rows
        assert calls == ["one", "rows"]
        assert gens.device_G().device == torch.device("cpu")
        # below the msm floor the host MSM runs
        gens.commit(values[:100], 3)
    assert calls == ["one", "rows"]


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_SELECTED", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.select()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        msm_v3.DeviceBasisV3(msm.vesta_kernels(),
                             [msm.vesta_kernels().curve.gen] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["ascii", "--commit", "-d", "unused.txt"])
    assert device.select("cpu") == torch.device("cpu")
    assert device.resolve() == torch.device("cpu")
    assert device.engine_type() == "cpu"
