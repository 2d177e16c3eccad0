"""K6's three round kernels (csrc/sumcheck.cu) and its table encode
(csrc/sc_encode.cu) on the card, exactly against their plain versions,
each launch counted.

The plain versions are held to the JAX package on the CPU by
tests/test_torch_sumcheck.py; this file imports neither JAX nor the JAX
package (the card lane, `pytest --noconftest -m cuda
tests/test_torch_card_*.py`).
"""

import numpy as np
import pytest
import torch

from _torch_card_support import rows
from reef_tpu_torch.ops import limb
from reef_tpu_torch.ops import sumcheck_device as SD
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


@pytest.mark.parametrize("table", ["dna_1mb", "near_2_63"])
def test_encode_matches_plain_on_card(table):
    """The table encode on the card, exactly against its plain version and
    the host encoder's table: the flagship's document table (1,000,000
    DNA codes padded to 2^20) and a 2^14 table of values just below
    2^63, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lf, dev = limb.FQ, torch.device("cuda")
    rng = np.random.default_rng(11)
    if table == "dna_1mb":
        vals, n_pad = rng.integers(0, 4, size=1_000_000), 1 << 20
    else:
        vals = (1 << 63) - 1 - rng.integers(0, 1 << 40, size=(1 << 14) - 3)
        n_pad = 1 << 14
    vals = torch.from_numpy(vals.astype(np.int64))
    before = cudabuild.launch_counts()["sumcheck_encode"]
    got = K.encode(lf, vals.to(dev), n_pad)
    torch.cuda.synchronize()
    assert cudabuild.launch_counts()["sumcheck_encode"] == before + 1
    assert torch.equal(got.cpu(), K.encode_plain(lf, vals, n_pad))
    cache = SD.DeviceTableCache(lf, vals.tolist(), device=dev)
    assert cudabuild.launch_counts()["sumcheck_encode"] == before + 2
    assert cache.ell == n_pad.bit_length() - 1
    words = SD._table_words(lf, vals.tolist())[1]
    assert torch.equal(cache.t_shards[0].cpu(),
                       torch.from_numpy(np.ascontiguousarray(words)))
