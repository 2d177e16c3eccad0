"""K3 and K4 (csrc/mont.cu) on the card, exactly against their plain
versions, each launch counted, and the MXU Poseidon under the hook
against K5.

The plain versions are held to the JAX package on the CPU by
tests/test_torch_field_kernel.py and tests/test_torch_field.py; this
file imports neither JAX nor the JAX package (the card lane,
`pytest --noconftest -m cuda tests/test_torch_card_*.py`).
"""

import pytest
import torch

from _torch_card_support import elements, encode, mxu_range_cols
from reef_tpu_torch.ops import field_kernel as FK
from reef_tpu_torch.ops import limb, poseidon_device, poseidon_mxu
from reef_tpu_torch.utils import cudabuild

pytestmark = pytest.mark.cuda

FIELDS = {"fp": limb.FP, "fq": limb.FQ}


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_kernels_match_plain_on_card(name):
    """K3 and K4 (csrc/mont.cu) on the card, exactly against their plain
    versions, each launch counted; the MXU Poseidon under the hook
    against K5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lf = FIELDS[name]
    dev = torch.device("cuda")
    B = 5000                                # not a multiple of 128
    a = encode(lf, elements(lf.p_int, B, 8))
    b = encode(lf, elements(lf.p_int, B, 9)[::-1])
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
    X = lf.encode32(elements(lf.p_int, 5 * 4096, 11)).reshape(
        limb.N32, 4096, 5).permute(2, 0, 1).contiguous().to(dev)
    with FK.enabled(redc=True):
        mxu = poseidon_mxu.permute(lf, X)
    assert torch.equal(mxu, poseidon_device.permute(lf, X))
    final = cudabuild.launch_counts()
    assert final["mont_mul"] > after["mont_mul"]
    assert final["mont_redc"] > after["mont_redc"]
