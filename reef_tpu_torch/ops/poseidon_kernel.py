"""K5: the batched Poseidon permutation as a CUDA kernel (csrc/poseidon.cu).

The port of the JAX package's ops/poseidon_pallas.py (`_perm_call` behind
its `permute`).  `launch` permutes each state of a (t, 8, B) int32 batch on
the card (t = 5 or 9, Montgomery, the layout of ops.poseidon_device),
whatever B, and counts the launch.  ops.poseidon_device.permute is the
wrapper that callers use: it sends CUDA tensors here and runs the plain
version on CPU tensors.  The kernel's tables are copied into its global
arrays once per process, field, width and card: the dense round
constants and MDS for SPREAD, the sparse tables
(ops.poseidon_constants.sparse_params) for THREAD; each block copies
its field's tables into shared memory.
Every launch adds one to the `poseidon` count, a SPREAD launch one to
`poseidon_spread` as well.

K5 has two launches: THREAD gives each state one thread (the Merkle
leaves, the flagship step) and runs sparse partial rounds with one REDC
a matrix row (`poseidon_device.permute_plain(..., sparse=True)` is its
plain twin); SPREAD gives each state a block of t row groups (a
sumcheck round's single sponge state, the top levels of a Merkle tree)
and runs the dense rounds (`spread=True`).  `route` picks one by batch size.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import torch

from ..utils import cudabuild
from .limb import LimbField

THREAD, SPREAD = 0, 1
# the least batch that goes to THREAD: below it SPREAD is faster on an
# H100 at both widths (the sweep of chip_smoke.py's poseidon phase)
THREAD_MIN_B = 1024

# (card, field id, t) whose constants are set: cudaMemcpyToSymbol fills
# the kernel's arrays on the current device only
_CONSTS_SET: Set[Tuple[torch.device, int, int]] = set()


def route(B: int) -> int:
    """The launch that permutes a batch of B states."""
    return SPREAD if B < THREAD_MIN_B else THREAD


def _set_consts(lf: LimbField, t: int, device: torch.device) -> None:
    """Fill K5's constants for (lf, t) on `device`, once per process."""
    key = (device, lf.field_id, t)
    if key in _CONSTS_SET:
        return
    from .poseidon_device import _device_consts, sparse_table
    rc, mds = _device_consts(lf, t)
    sparse = sparse_table(lf, t)
    with torch.cuda.device(device):
        err = cudabuild.library("poseidon").reef_poseidon_set_consts(
            lf.field_id, t, rc.ctypes.data, mds.ctypes.data,
            sparse.ctypes.data)
    cudabuild.check(err, "reef_poseidon_set_consts")
    _CONSTS_SET.add(key)


def launch(lf: LimbField, state: torch.Tensor,
           path: Optional[int] = None) -> torch.Tensor:
    """(t, 8, B) int32 CUDA tensor -> a new one, each state permuted, by
    the launch `path` (THREAD or SPREAD; default `route(B)`)."""
    if not cudabuild.on_card("K5", state):
        raise ValueError(f"K5: a CUDA tensor is needed, not {state.device}")
    t = state.shape[0]
    if t not in (5, 9):
        raise ValueError(f"K5: the kernel serves t = 5 and 9, not {t}")
    if not state.is_contiguous():
        raise ValueError("K5: state is not contiguous")
    out = torch.empty_like(state)
    B = state.shape[2]
    if path is None:
        path = route(B)
    if path not in (THREAD, SPREAD):
        raise ValueError(f"K5: no launch {path}")
    if B:
        _set_consts(lf, t, state.device)
        cudabuild.launch("poseidon", "reef_poseidon", state.device,
                         state.data_ptr(), out.data_ptr(), B, t,
                         lf.field_id, path)
        cudabuild.count("poseidon")
        if path == SPREAD:
            cudabuild.count("poseidon_spread")
    return out
