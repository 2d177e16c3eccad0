"""reef_tpu_torch device MSM (ec/msm_v3.py) and its routing, on the CPU.

On CPU tensors the MSM runs the kernels' plain versions through the same
sort / count / gather / Fenwick glue that drives the kernels on the card.
Its results must equal the JAX package's python-int and native host MSMs
exactly.  `convert.py` must carry the JAX package's device basis over to
the port's.
"""

import numpy as np
import pytest
import torch

from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu.ec import msm as ref_msm
from reef_tpu.ec import msm_v3 as ref_v3
from reef_tpu.ec import native_msm as ref_native
from reef_tpu.ec import pasta as ref_pasta
from reef_tpu_torch import cli, convert
from reef_tpu_torch.backend import commitment as CM
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
    """REEF_DEVICE_MSM=1: commit and commit_rows take the device MSM and
    give the host route's points."""
    n = CM.DEVICE_MSM_MIN_N
    gens = CM.PedersenGens(PALLAS, b"test_torch_msm/commit", n)
    values = _scalars(PALLAS, n, 28)
    flat = _scalars(PALLAS, n, 29)
    blinds = [5]

    monkeypatch.setenv("REEF_DEVICE_MSM", "0")
    host = gens.commit(values, 3)
    host_rows = gens.commit_rows(flat, blinds)

    calls = []
    orig, orig_rows = msm_v3.msm_device_v3, msm_v3.msm_device_v3_rows
    monkeypatch.setattr(msm_v3, "msm_device_v3",
                        lambda *a: calls.append("one") or orig(*a))
    monkeypatch.setattr(msm_v3, "msm_device_v3_rows",
                        lambda *a: calls.append("rows") or orig_rows(*a))
    monkeypatch.setattr(CM, "DEVICE_ROWS_MIN_N", n)
    monkeypatch.setenv("REEF_DEVICE_MSM", "1")
    assert gens.commit(values, 3) == host
    assert gens.commit_rows(flat, blinds) == host_rows
    assert calls == ["one", "rows"]
    assert gens.device_G().device == torch.device("cpu")
    # below DEVICE_MSM_MIN_N the host MSM runs even when forced
    gens.commit(values[:100], 3)
    assert calls == ["one", "rows"]


def test_device_msm_gate(monkeypatch, cpu_engine):
    monkeypatch.delenv("REEF_DEVICE_PROFILE", raising=False)
    monkeypatch.setenv("REEF_DEVICE_MSM", "0")
    assert not CM._device_msm_on(1 << 16)
    monkeypatch.setenv("REEF_DEVICE_MSM", "1")
    assert CM._device_msm_on(1 << 16)
    monkeypatch.setenv("REEF_DEVICE_MSM", "auto")
    assert not CM._device_msm_on(1 << 16)          # the engine is the CPU
    monkeypatch.setenv("REEF_DEVICE_PROFILE", "local-accel")
    assert CM._device_msm_on(CM.DEVICE_MSM_MIN_N)
    assert not CM._device_msm_on(CM.DEVICE_MSM_MIN_N - 1)
    assert (CM.DEVICE_MSM_MIN_N, CM.DEVICE_ROWS_MIN_N) == (256, 4096)


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
    assert device.device_profile() == "cpu"
