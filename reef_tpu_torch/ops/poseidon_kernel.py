"""K5: the batched Poseidon permutation as a CUDA kernel (csrc/poseidon.cu).

The port of the JAX package's ops/poseidon_pallas.py (`_perm_call` behind
its `permute`).  `launch` permutes each state of a (t, 8, B) int32 batch on
the card (t = 5 or 9, Montgomery, the layout of ops.poseidon_device),
whatever B, and counts the launch.  ops.poseidon_device.permute is the
wrapper that callers use: it sends CUDA tensors here and runs the plain
version on CPU tensors.  The kernel's round constants and MDS are copied
into its constant banks once per process, field and width.
"""

from __future__ import annotations

from typing import Set, Tuple

import torch

from ..utils import cudabuild
from .limb import LimbField

_CONSTS_SET: Set[Tuple[int, int]] = set()


def _set_consts(lib, lf: LimbField, t: int) -> None:
    if (lf.field_id, t) in _CONSTS_SET:
        return
    from .poseidon_device import _device_consts
    rc, mds = _device_consts(lf, t)
    err = lib.reef_poseidon_set_consts(lf.field_id, t, rc.ctypes.data,
                                       mds.ctypes.data)
    cudabuild.check(err, "reef_poseidon_set_consts")
    _CONSTS_SET.add((lf.field_id, t))


def launch(lf: LimbField, state: torch.Tensor) -> torch.Tensor:
    """(t, 8, B) int32 CUDA tensor -> a new one, each state permuted."""
    if state.device.type != "cuda":
        raise ValueError(f"K5: a CUDA tensor is needed, not {state.device}")
    t = state.shape[0]
    if t not in (5, 9):
        raise ValueError(f"K5: the kernel serves t = 5 and 9, not {t}")
    if not state.is_contiguous():
        raise ValueError("K5: state is not contiguous")
    out = torch.empty_like(state)
    B = state.shape[2]
    if B:
        lib = cudabuild.library("poseidon")
        _set_consts(lib, lf, t)
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.reef_poseidon(state.data_ptr(), out.data_ptr(), B, t,
                                lf.field_id, stream)
        cudabuild.check(err, "reef_poseidon")
        cudabuild.count("poseidon")
    return out
