"""The v2 Pippenger MSM (ec/msm_pippenger.py) on the card, its point
adds' products on K3, against the port's python curve.

That curve is held to the JAX package's on the CPU by
tests/test_torch_pippenger.py; this file imports neither JAX nor the
JAX package (the card lane, `pytest --noconftest -m cuda
tests/test_torch_card_*.py`).
"""

import random

import pytest
import torch

from reef_tpu_torch.ec import msm, msm_pippenger as mp
from reef_tpu_torch.ec.pasta import PALLAS
from reef_tpu_torch.ops import limb
from reef_tpu_torch.utils import cudabuild

pytestmark = pytest.mark.cuda

ORDER = PALLAS.order


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
