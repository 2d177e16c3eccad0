"""Both K5 launches (csrc/poseidon.cu) on the card, exactly against the
plain version and the port's python permutation, each launch counted.

The plain version and the python permutation are held to the JAX
package on the CPU by tests/test_torch_poseidon.py; this file imports
neither JAX nor the JAX package (the card lane, `pytest --noconftest
-m cuda tests/test_torch_card_*.py`).
"""

import pytest
import torch

from _torch_card_support import edge_states, from_port, states, to_port
from reef_tpu_torch.ops import limb, poseidon, poseidon_device, poseidon_kernel
from reef_tpu_torch.ops.poseidon_constants import host_permutation
from reef_tpu_torch.utils import cudabuild

pytestmark = pytest.mark.cuda

FIELDS = {"fq": limb.FQ, "fp": limb.FP}


@pytest.mark.parametrize("t", [5, 9])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_kernel_matches_plain_on_card(name, t):
    """Both K5 launches on the card on the edge states, at B = 1, 2, 37
    and on either side of the crossover, exactly against the plain
    version and the host permutation, each launch counted; `permute`
    routes by B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lf = FIELDS[name]
    cross = poseidon_kernel.THREAD_MIN_B
    batches = [edge_states(lf, t)] + [
        states(lf, t, B, seed=t + B) for B in (1, 2, 37, cross - 1, cross)]
    for sts in batches:
        B = len(sts)
        x = to_port(lf, sts, "cuda")
        want = poseidon_device.permute_plain(lf, x.cpu())
        for path in (poseidon_kernel.THREAD, poseidon_kernel.SPREAD):
            before = cudabuild.launch_counts()
            got = poseidon_kernel.launch(lf, x, path)
            torch.cuda.synchronize()
            after = cudabuild.launch_counts()
            assert after["poseidon"] == before["poseidon"] + 1
            assert after["poseidon_spread"] == before["poseidon_spread"] + (
                path == poseidon_kernel.SPREAD)
            assert torch.equal(got.cpu(), want), (B, path)
            assert from_port(lf, got[:, :, :9]) == [
                host_permutation(lf.p_int, s) for s in sts[:9]]
        before = cudabuild.launch_counts()["poseidon_spread"]
        assert torch.equal(poseidon.permute(lf, x).cpu(), want)
        assert cudabuild.launch_counts()["poseidon_spread"] == before + (
            B < cross)
