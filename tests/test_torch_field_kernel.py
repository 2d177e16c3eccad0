"""reef_tpu_torch's field kernels (K3, K4) and their dispatch hook,
against the JAX package.

On the CPU `mont_mul` and `mont_redc_cols` run their plain versions; the
reference's Pallas kernels run in interpret mode, as
tests/test_pallas_field.py runs them.  Every comparison is exact: the
same Montgomery integers, limb for limb.  The `cuda`-marked test runs K3
and K4 on a card against the plain versions, and the MXU Poseidon under
the hook against K5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu.ops import limb as ref_limb
from reef_tpu.ops import pallas_field as ref_pf
from reef_tpu_torch.ops import field_kernel as FK
from reef_tpu_torch.ops import limb, poseidon_device, poseidon_mxu
from reef_tpu_torch.utils import cudabuild
from test_torch_field import mxu_range_cols

FIELDS = {"fp": (limb.FP, ref_limb.FP), "fq": (limb.FQ, ref_limb.FQ)}


def _elements(p: int, n: int, seed: int) -> list:
    """0, 1, p - 1, then random values below p."""
    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1]
    while len(vals) < n:
        vals.append(int.from_bytes(rng.bytes(32), "little") % p)
    return vals


def _encode(lf, xs) -> torch.Tensor:
    """Python ints -> contiguous (16, n) int64 Montgomery rows."""
    return lf.encode(xs).contiguous()


def _ref_rows(t: torch.Tensor) -> np.ndarray:
    """Port (16, B) int64 -> reference (B, 16) uint32."""
    return np.ascontiguousarray(t.numpy().T.astype(np.uint32))


@pytest.mark.parametrize("name,B", [("fq", 1024), ("fp", 1024),
                                    ("fq", 1100)])
def test_mont_mul_matches_reference(name, B):
    lf, rf = FIELDS[name]
    p = lf.p_int
    xs, ys = _elements(p, B, 1), _elements(p, B, 2)[::-1]
    a, b = _encode(lf, xs), _encode(lf, ys)
    got = FK.mont_mul(lf, a, b)
    want = ref_pf.mont_mul(rf, jnp.asarray(_ref_rows(a)),
                           jnp.asarray(_ref_rows(b)), interpret=True)
    np.testing.assert_array_equal(_ref_rows(got), np.asarray(want))
    assert lf.decode(got) == [x * y % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name,B", [("fq", 1024), ("fp", 1100)])
def test_mont_redc_cols_matches_reference(name, B):
    """MXU-range columns (below 2^31, values in [pR, 5p^2)) against the
    reference kernel; a product's schoolbook columns (port only: they
    exceed 32 bits) against `mont_mul`."""
    lf, rf = FIELDS[name]
    cols = mxu_range_cols(lf.p_int, B, 30 + B)
    got = FK.mont_redc_cols(lf, torch.from_numpy(cols))
    want = ref_pf.mont_redc_cols(rf, jnp.asarray(cols.T.astype(np.uint32)),
                                 interpret=True)
    np.testing.assert_array_equal(_ref_rows(got), np.asarray(want))

    a = _encode(lf, _elements(lf.p_int, B, 3))
    b = _encode(lf, _elements(lf.p_int, B, 4)[::-1])
    school = torch.zeros((32, B), dtype=torch.int64)
    for i in range(16):
        school[i:i + 16] += a[i] * b
    assert torch.equal(FK.mont_redc_cols(lf, school), FK.mont_mul(lf, a, b))


def test_wrappers_check_their_inputs():
    lf = limb.FQ
    a = _encode(lf, [1, 2, 3])
    with pytest.raises(TypeError):
        FK.mont_mul(lf, a.int(), a)
    with pytest.raises(ValueError):
        FK.mont_mul(lf, a, a[:, :2])
    with pytest.raises(ValueError):
        FK.mont_mul(lf, a.T.contiguous().T, a)
    with pytest.raises(ValueError):
        FK.mont_redc_cols(lf, a)


def test_enable_disable_reroute_the_plain_ops():
    """enable() rebinds limb.mul (and with redc=True limb.redc_cols) to
    the dispatchers, which send CPU tensors to the plain versions;
    disable() puts the plain functions back, and enabled() puts back
    what was bound before it, also when its block raises."""
    base_mul, base_redc = limb.mul, limb.redc_cols
    lf = limb.FP
    a = _encode(lf, _elements(lf.p_int, 256, 5)).reshape(16, 2, 128)
    b = _encode(lf, _elements(lf.p_int, 128, 6)).reshape(16, 1, 128)
    want = base_mul(lf, a, b)
    before = cudabuild.launch_counts()
    try:
        FK.enable()
        assert limb.mul is FK._dispatching_mul
        assert limb.redc_cols is base_redc
        assert torch.equal(limb.mul(lf, a, b), want)
        assert torch.equal(limb.pow5(lf, b), base_mul(
            lf, base_mul(lf, base_mul(lf, b, b), base_mul(lf, b, b)), b))
        with FK.enabled(redc=True):
            assert limb.redc_cols is FK._dispatching_redc_cols
            cols = torch.from_numpy(mxu_range_cols(lf.p_int, 128, 7))
            assert torch.equal(limb.redc_cols(lf, cols),
                               base_redc(lf, cols))
        assert limb.mul is FK._dispatching_mul
        assert limb.redc_cols is base_redc
        assert cudabuild.launch_counts() == before       # nothing launched
    finally:
        FK.disable()
    assert limb.mul is base_mul and limb.redc_cols is base_redc
    with pytest.raises(RuntimeError):
        with FK.enabled(redc=True):
            raise RuntimeError("kernel failed")
    assert limb.mul is base_mul and limb.redc_cols is base_redc


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_kernels_match_plain_on_card(name):
    """K3 and K4 (csrc/mont.cu) on the card, exactly against their plain
    versions, each launch counted; the MXU Poseidon under the hook
    against K5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lf, _ = FIELDS[name]
    dev = torch.device("cuda")
    B = 5000                                # not a multiple of 128
    a = _encode(lf, _elements(lf.p_int, B, 8))
    b = _encode(lf, _elements(lf.p_int, B, 9)[::-1])
    cols = torch.from_numpy(mxu_range_cols(lf.p_int, B, 10))
    before = cudabuild.launch_counts()
    got = FK.mont_mul(lf, a.to(dev), b.to(dev))
    red = FK.mont_redc_cols(lf, cols.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), limb.mul(lf, a, b))
    assert torch.equal(red.cpu(), limb.redc_cols(lf, cols))
    after = cudabuild.launch_counts()
    assert after["mont_mul"] == before["mont_mul"] + 1
    assert after["mont_redc"] == before["mont_redc"] + 1
    X = lf.encode32(_elements(lf.p_int, 5 * 4096, 11)).reshape(
        limb.N32, 4096, 5).permute(2, 0, 1).contiguous().to(dev)
    with FK.enabled(redc=True):
        mxu = poseidon_mxu.permute(lf, X)
    assert torch.equal(mxu, poseidon_device.permute(lf, X))
    final = cudabuild.launch_counts()
    assert final["mont_mul"] > after["mont_mul"]
    assert final["mont_redc"] > after["mont_redc"]
