"""K1 (csrc/padd.cu) and K2 (csrc/msm_tree.cu) on the card, exactly
against their plain versions, each launch counted.

The plain versions are held to the JAX package on the CPU by
tests/test_torch_ec.py; this file imports neither JAX nor the JAX
package, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_card_*.py

Every test skips where torch sees no CUDA device.
"""

import pytest
import torch

from _torch_card_support import pairs, soa
from reef_tpu_torch.backend.commitment import PedersenGens
from reef_tpu_torch.ec import msm, msm_v3
from reef_tpu_torch.ec import padd as PD
from reef_tpu_torch.ec.padd import padd_soa, padd_soa_plain
from reef_tpu_torch.utils import cudabuild

pytestmark = pytest.mark.cuda

CURVES = {"pallas": msm.pallas_kernels, "vesta": msm.vesta_kernels}


@pytest.mark.parametrize("name", sorted(CURVES))
def test_kernels_match_plain_on_card(name):
    """K1 (csrc/padd.cu: routed by batch size, and its thread-a-lane
    launch) and K2 (csrc/msm_tree.cu, at cap 4096 and 16384) on the
    card, exactly against their plain versions, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ck = CURVES[name]()
    cv = ck.curve
    dev = torch.device("cuda")
    prs = pairs(cv, 14) * 300
    P = soa(ck, [a for a, _ in prs]).to(dev)
    Q = soa(ck, [b for _, b in prs]).to(dev)
    before = cudabuild.launch_counts()["padd"]
    got = padd_soa(ck, P, Q)
    assert torch.equal(got.cpu(), padd_soa_plain(ck, P.cpu(), Q.cpu()))
    assert cudabuild.launch_counts()["padd"] == before + 1
    # the thread-a-lane launch too (padd_soa routes this batch by size)
    before = cudabuild.launch_counts()
    got = padd_soa(ck, P, Q, path=PD.THREAD)
    assert torch.equal(got.cpu(), padd_soa_plain(ck, P.cpu(), Q.cpu()))
    after = cudabuild.launch_counts()
    assert after["padd"] == before["padd"] + 1
    assert after["padd_spread"] == before["padd_spread"]
    g = torch.Generator().manual_seed(15)
    for cap in (4096, 16384):
        W = 32
        order = torch.stack([torch.randperm(cap, generator=g)
                             for _ in range(W)])
        base = soa(ck, PedersenGens(cv, b"test_torch_ec/tree", cap).G)
        placed = base[:2][:, :, order].contiguous().to(dev)
        before = cudabuild.launch_counts()["msm_tree"]
        tree = msm_v3.tree_levels(ck, placed)
        torch.cuda.synchronize()
        assert torch.equal(tree[..., :cap - 1],
                           msm_v3.tree_levels_plain(ck, placed)[..., :cap - 1])
        assert cudabuild.launch_counts()["msm_tree"] == \
            before + len(msm_v3.tree_plan(cap))


@pytest.mark.parametrize("name", sorted(CURVES))
def test_spread_and_reduce_match_plain_on_card(name):
    """K1's SPREAD launch at a few batches and its reduce at the MSM's two
    shapes (the Fenwick levels with acc, the digits) on the card, exactly
    against the plain versions, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ck = CURVES[name]()
    dev = torch.device("cuda")
    prs = pairs(ck.curve, 19) * 8
    P = soa(ck, [a for a, _ in prs])
    Q = soa(ck, [b for _, b in prs])
    for B in (1, 2, 37):
        p, q = P[..., :B].contiguous(), Q[..., :B].contiguous()
        before = cudabuild.launch_counts()["padd_spread"]
        got = padd_soa(ck, p.to(dev), q.to(dev), path=PD.SPREAD)
        assert torch.equal(got.cpu(), padd_soa_plain(ck, p, q))
        assert cudabuild.launch_counts()["padd_spread"] == before + 1
    base = padd_soa_plain(ck, P, Q)
    for A, L, C, with_acc in ((32, 16, 256, True), (32, 256, 1, False)):
        idx = torch.arange(A * L * C) % base.shape[2]
        X = base[:, :, idx].reshape(3, 8, A, L, C).contiguous()
        acc = (base[:, :, idx[:A * C].flip(0)].reshape(3, 8, A, C)
               .contiguous() if with_acc else None)
        before = cudabuild.launch_counts()["padd_reduce"]
        got = PD.padd_reduce(ck, X.to(dev),
                             None if acc is None else acc.to(dev))
        torch.cuda.synchronize()
        assert cudabuild.launch_counts()["padd_reduce"] == before + 1
        assert torch.equal(got.cpu(), PD.padd_reduce_plain(ck, X, acc))
