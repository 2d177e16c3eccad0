"""K6's three kernels (csrc/sumcheck.cu) on the card, exactly against
their plain versions, each launch counted.

The plain versions are held to the JAX package on the CPU by
tests/test_torch_sumcheck.py; this file imports neither JAX nor the JAX
package (the card lane, `pytest --noconftest -m cuda
tests/test_torch_card_*.py`).
"""

import pytest
import torch

from _torch_card_support import rows
from reef_tpu_torch.ops import limb
from reef_tpu_torch.ops import sumcheck_kernel as K
from reef_tpu_torch.utils import cudabuild

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("half", [1, 256, 1 << 12])
def test_kernels_match_plain_on_card(half):
    """K6's three kernels on the card, exactly against their plain
    versions, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lf, dev = limb.FQ, torch.device("cuda")
    T, E, r = rows(2 * half, 1), rows(2 * half, 2), rows(1, 3)
    st = rows(9, 4).T.reshape(9, 8, 1).contiguous()
    halves = (T[:, :half], T[:, half:], E[:, :half], E[:, half:])
    dh = [h.to(dev) for h in halves]
    before = cudabuild.launch_counts()
    g, s = K.coeffs(lf, *dh, st.to(dev))
    fk = K.fold(lf, *dh, r.to(dev))
    ek = K.eq_step(lf, T[:, :half].contiguous().to(dev), r.to(dev), E.to(dev))
    torch.cuda.synchronize()
    after = cudabuild.launch_counts()
    gp, sp = K.coeffs_plain(lf, *halves, st)
    fp = K.fold_plain(lf, *halves, r)
    assert torch.equal(g.cpu(), gp) and torch.equal(s.cpu(), sp)
    assert torch.equal(fk[0].cpu(), fp[0]) and torch.equal(fk[1].cpu(), fp[1])
    assert torch.equal(ek.cpu(), K.eq_step_plain(lf, T[:, :half], r, E))
    assert after["sumcheck_coeffs"] == before["sumcheck_coeffs"] + 1
    assert after["sumcheck_fold"] == before["sumcheck_fold"] + 1
    assert after["sumcheck_eq"] == before["sumcheck_eq"] + 1


def test_coeffs_match_plain_at_every_round_on_card():
    """The coefficient launch at every half of a 2^20-entry sumcheck,
    with and without a sponge state, exactly against the plain version,
    one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lf, dev = limb.FQ, torch.device("cuda")
    T, E = rows(1 << 20, 5).to(dev), rows(1 << 20, 6).to(dev)
    st = rows(9, 7).T.reshape(9, 8, 1).contiguous().to(dev)
    for log_half in range(19, -1, -1):
        h = 1 << log_half
        halves = (T[:, :h], T[:, h:2 * h], E[:, :h], E[:, h:2 * h])
        for state in (st, None):
            before = cudabuild.launch_counts()["sumcheck_coeffs"]
            g, s = K.coeffs(lf, *halves, state)
            torch.cuda.synchronize()
            assert cudabuild.launch_counts()["sumcheck_coeffs"] == before + 1
            gp, sp = K.coeffs_plain(lf, *halves, state)
            assert torch.equal(g, gp)
            assert (s is None and sp is None) or torch.equal(s, sp)
