"""Batched complete point addition on (3, 8, B) int32 point arrays.

`padd_soa` is the port of `_padd_call`/`padd_soa` in the JAX package's
ec/pallas_ec.py: one RCB16 a = 0 complete addition per lane.  On a CUDA
tensor it launches the hand-written kernel in csrc/padd.cu; on a CPU
tensor it runs `padd_soa_plain`, the same arithmetic in plain torch.
`msm_pallas` is the port of the same module's MSM over that kernel.
"""

from __future__ import annotations

import torch

from ..ops import limb
from ..utils import cudabuild
from .msm import CurveKernels, padd, scalar_bits


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


# ---------------------------------------------------------------------------
# the lane-parallel double-and-add MSM over K1
# ---------------------------------------------------------------------------

BLOCK = 1024    # lanes a group runs together (the reference's kernel block)


def _ident_soa(ck: CurveKernels, n: int, device) -> torch.Tensor:
    return ck.ident_t(device)[:, :, None].expand(3, limb.N32, n).contiguous()


def _group_products(ck: CurveKernels, bits: torch.Tensor,
                    pts: torch.Tensor) -> torch.Tensor:
    """Double-and-add for ONE group of BLOCK lanes: bits (nbits, BLOCK)
    bool, pts (3, 8, BLOCK).  Every lane runs its own scalar product with
    two `padd_soa` calls a bit; a halving tree then sums the lanes.
    Returns (3, 8, 1)."""
    ident = _ident_soa(ck, pts.shape[2], pts.device)
    acc = ident
    for row in bits:
        acc = padd_soa(ck, padd_soa(ck, acc, acc),
                       torch.where(row, pts, ident))
    n = acc.shape[2]
    while n > 1:
        half = n // 2
        acc = padd_soa(ck, acc[..., :half].contiguous(),
                       acc[..., half:2 * half].contiguous())
        n = half
    return acc


def msm_pallas(ck: CurveKernels, scalars, points, device=None
               ) -> torch.Tensor:
    """MSM over K1 in groups of BLOCK lanes; `points` is a list of affine
    host points (uploaded to `device`, default the engine device) or an
    (n, 3, 8) int32 projective tensor, whose device it keeps.  Returns the
    projective (3, 8) int32 sum.  The bit count is cut to the longest
    scalar: leading zero bits would only double the identity."""
    if isinstance(points, list):
        from ..utils.device import resolve
        points = torch.from_numpy(ck.to_proj(points)).to(resolve(device))
    n = len(scalars)
    if tuple(points.shape) != (n, 3, limb.N32):
        raise ValueError(f"points: shape {tuple(points.shape)}, expected "
                         f"({n}, 3, {limb.N32})")
    dev = points.device
    n2 = -(-n // BLOCK) * BLOCK
    pts = points.permute(1, 2, 0).contiguous()        # (3, 8, n)
    if n2 != n:
        pts = torch.cat([pts, _ident_soa(ck, n2 - n, dev)], dim=2)
    order = ck.curve.order
    scalars = [int(s) % order for s in scalars] + [0] * (n2 - n)
    nbits = max(1, max(s.bit_length() for s in scalars))
    bits = torch.from_numpy(scalar_bits(scalars, nbits)).to(dev)
    acc = None
    for g in range(n2 // BLOCK):
        sl = slice(g * BLOCK, (g + 1) * BLOCK)
        prod = _group_products(ck, bits[:, sl], pts[..., sl].contiguous())
        acc = prod if acc is None else padd_soa(ck, acc, prod)
    return acc[..., 0]
