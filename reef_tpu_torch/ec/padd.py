"""Batched complete point addition on (3, 8, B) int32 point arrays.

`padd_soa` is the port of `_padd_call`/`padd_soa` in the JAX package's
ec/pallas_ec.py: one RCB16 a = 0 complete addition per lane.  On a CUDA
tensor it launches the hand-written kernel in csrc/padd.cu; on a CPU
tensor it runs `padd_soa_plain`, the same arithmetic in plain torch.
"""

from __future__ import annotations

import torch

from ..ops import limb
from ..utils import cudabuild
from .msm import CurveKernels, padd


def _check_points(name: str, t: torch.Tensor, coords: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if t.dim() != 3 or t.shape[0] != coords or t.shape[1] != limb.N32:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"({coords}, {limb.N32}, B)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def padd_soa_plain(ck: CurveKernels, P: torch.Tensor,
                   Q: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version, on any device."""
    return limb_join(padd(ck, limb_split(P), limb_split(Q)))


def limb_split(P: torch.Tensor) -> torch.Tensor:
    """(c, 8, ...) int32 -> (c, 16, ...) int64, per coordinate."""
    return torch.stack([limb.split32(P[c]) for c in range(P.shape[0])])


def limb_join(P: torch.Tensor) -> torch.Tensor:
    """(c, 16, ...) int64 -> (c, 8, ...) int32, per coordinate."""
    return torch.stack([limb.join16(P[c]) for c in range(P.shape[0])])


def padd_soa(ck: CurveKernels, P: torch.Tensor,
             Q: torch.Tensor) -> torch.Tensor:
    """(3, 8, B) + (3, 8, B) -> (3, 8, B) int32, lane by lane."""
    _check_points("P", P, 3)
    _check_points("Q", Q, 3)
    if P.shape != Q.shape or P.device != Q.device:
        raise ValueError("P and Q differ in shape or device")
    if P.device.type == "cpu":
        return padd_soa_plain(ck, P, Q)
    if P.device.type != "cuda":
        raise ValueError(f"padd_soa: unsupported device {P.device}")
    out = torch.empty_like(P)
    B = P.shape[2]
    if B:
        lib = cudabuild.library("padd")
        stream = torch.cuda.current_stream(P.device).cuda_stream
        err = lib.reef_padd(P.data_ptr(), Q.data_ptr(), out.data_ptr(), B,
                            ck.lf.field_id, stream)
        cudabuild.check(err, "reef_padd")
        cudabuild.count("padd")
    return out
