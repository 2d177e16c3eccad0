"""Batched complete point addition on (3, 8, B) int32 point arrays.

`padd_soa` is the port of `_padd_call`/`padd_soa` in the JAX package's
ec/pallas_ec.py: one RCB16 a = 0 complete addition per lane.  On a CUDA
tensor it launches the hand-written kernel in csrc/padd.cu; on a CPU
tensor it runs `padd_soa_plain`, the same arithmetic in plain torch.
`padd_reduce` sums a power-of-two axis of points by halving, as the
reference's MSM does over its Fenwick levels and its digits with one
`padd_soa` call a level, in one launch.  `msm_pallas` is the port of the
same module's MSM over that kernel.

K1 has two launches of the add: THREAD gives each lane one thread (wide
batches), SPREAD gives each lane a group of six threads (narrow ones);
`route` picks one by batch size, and the reduce picks one level by level
(`reduce_plan`).  Every K1 launch adds one to the `padd` count, a SPREAD
one to `padd_spread` as well, a reduce one to `padd_reduce`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops import limb
from ..utils import cudabuild
from .msm import CurveKernels, padd, scalar_bits

THREAD, SPREAD = 0, 1
# the least batch that goes to THREAD: below it SPREAD is faster on an
# H100 (the sweep of chip_smoke.py's padd phase: SPREAD 14.9 against 18.5
# us at 16384 lanes, THREAD 20.8 against 26.0 at 32768)
THREAD_MIN_B = 32768
SPREAD_THREADS = 6       # threads a SPREAD add (csrc/padd.cu SPREAD)
REDUCE_MAX_THREADS = 384
REDUCE_MAX_L = 256       # the reduce's points fit 48 KB of shared memory


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


def route(B: int) -> int:
    """The launch that adds a batch of B lanes."""
    return SPREAD if B < THREAD_MIN_B else THREAD


def launch(ck: CurveKernels, P: torch.Tensor, Q: torch.Tensor,
           path: int) -> torch.Tensor:
    """K1's add by the launch `path` (THREAD or SPREAD) on checked
    (3, 8, B) CUDA tensors; counts the launch."""
    if path not in (THREAD, SPREAD):
        raise ValueError(f"K1: no launch {path}")
    out = torch.empty_like(P)
    B = P.shape[2]
    if B:
        cudabuild.launch("padd", "reef_padd", P.device, P.data_ptr(),
                         Q.data_ptr(), out.data_ptr(), B, ck.lf.field_id,
                         path)
        cudabuild.count("padd")
        if path == SPREAD:
            cudabuild.count("padd_spread")
    return out


def padd_soa(ck: CurveKernels, P: torch.Tensor, Q: torch.Tensor,
             path: Optional[int] = None) -> torch.Tensor:
    """(3, 8, B) + (3, 8, B) -> (3, 8, B) int32, lane by lane; on the card
    by the launch `path` (default `route(B)`)."""
    _check_points("P", P, 3)
    _check_points("Q", Q, 3)
    if P.shape != Q.shape or P.device != Q.device:
        raise ValueError("P and Q differ in shape or device")
    if path is None:
        path = route(P.shape[2])
    if path not in (THREAD, SPREAD):
        raise ValueError(f"padd_soa: no launch {path}")
    if not cudabuild.on_card("padd_soa", P):
        return padd_soa_plain(ck, P, Q)
    return launch(ck, P, Q, path)


# ---------------------------------------------------------------------------
# the halving reduce
# ---------------------------------------------------------------------------

def reduce_plan(n_out: int, L: int, acc: bool,
                sms: int) -> Tuple[int, int, int]:
    """(outputs a block, threads a block, spread mask) of the reduce of
    n_out sums of L points (plus acc) on a card of `sms` SMs: level lev
    (0 = the first halving, log2 L = the acc add) adds by SPREAD, bit lev
    of the mask, where the level's adds over the whole grid are fewer
    than THREAD_MIN_B, as `route` decides for one launch.  A block takes
    enough outputs for 128 first-level adds; a grid under one block an SM
    (latency-bound) gets up to six threads a first-level add."""
    half = L // 2
    gpb = max(1, 128 // half)
    adds = [n_out * (half >> lev) for lev in range(L.bit_length() - 1)]
    adds += [n_out] if acc else []
    mask = sum(1 << lev for lev, n in enumerate(adds) if n < THREAD_MIN_B)
    threads = 128
    if mask and -(-n_out // gpb) < sms:
        threads = max(128, min(REDUCE_MAX_THREADS,
                               SPREAD_THREADS * gpb * half))
    return gpb, threads, mask


def _reduce_args(X: torch.Tensor, acc: Optional[torch.Tensor]):
    """Check X (3, 8, A, L, C) and acc (3, 8, A, C); returns L."""
    if X.dtype != torch.int32:
        raise TypeError(f"padd_reduce: dtype {X.dtype}, expected int32")
    if X.dim() != 5 or X.shape[0] != 3 or X.shape[1] != limb.N32:
        raise ValueError(f"padd_reduce: shape {tuple(X.shape)}, expected "
                         f"(3, {limb.N32}, A, L, C)")
    L = X.shape[3]
    if L < 2 or L & (L - 1) or L > REDUCE_MAX_L:
        raise ValueError(f"padd_reduce: L = {L} is not a power of two in "
                         f"[2, {REDUCE_MAX_L}]")
    if acc is not None and (
            acc.dtype != torch.int32 or not acc.is_contiguous()
            or acc.shape != X.shape[:3] + X.shape[4:]
            or acc.device != X.device):
        raise ValueError(f"padd_reduce: acc {tuple(acc.shape)} is not a "
                         f"contiguous int32 (3, {limb.N32}, A, C) tensor "
                         f"beside X")
    return L


AddFn = Callable[[CurveKernels, torch.Tensor, torch.Tensor], torch.Tensor]


def padd_reduce_plain(ck: CurveKernels, X: torch.Tensor,
                      acc: Optional[torch.Tensor] = None,
                      add: AddFn = padd_soa_plain) -> torch.Tensor:
    """The reduce kernel's plain version, on any device: one call of the
    (3, 8, B) point add `add` a level over contiguous copies (with
    `padd_soa` on the card, the one K1 launch a level that the reduce
    kernel replaced)."""
    L = _reduce_args(X, acc)
    while L > 1:
        L //= 2
        A, B = X[..., :L, :], X[..., L:2 * L, :]
        X = add(ck, A.reshape(3, limb.N32, -1).contiguous(),
                B.reshape(3, limb.N32, -1).contiguous()).reshape(A.shape)
    out = X[..., 0, :]
    if acc is not None:
        out = add(ck, acc.reshape(3, limb.N32, -1),
                  out.reshape(3, limb.N32, -1).contiguous()
                  ).reshape(acc.shape)
    return out.contiguous()


def padd_reduce(ck: CurveKernels, X: torch.Tensor,
                acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(3, 8, A, L, C) -> (3, 8, A, C) int32: each (a, c) the sum of its L
    points by halving (point j plus point j + L/2, level by level), plus
    acc (3, 8, A, C) where given (acc + sum).  X may be any strided view
    whose two leading axes are uniform rows; on the card one launch."""
    L = _reduce_args(X, acc)
    if X.stride(0) != limb.N32 * X.stride(1):
        raise ValueError(f"padd_reduce: strides {X.stride()} do not make "
                         f"uniform coordinate rows")
    if not cudabuild.on_card("padd_reduce", X):
        return padd_reduce_plain(ck, X, acc)
    _, _, A, _, C = X.shape
    n_out = A * C
    out = torch.empty((3, limb.N32, A, C), dtype=torch.int32,
                      device=X.device)
    if n_out:
        sms = torch.cuda.get_device_properties(X.device) \
            .multi_processor_count
        gpb, threads, mask = reduce_plan(n_out, L, acc is not None, sms)
        cudabuild.launch(
            "padd", "reef_padd_reduce", X.device, X.data_ptr(),
            X.stride(1), n_out, C, X.stride(2), X.stride(4), X.stride(3), L,
            0 if acc is None else acc.data_ptr(), out.data_ptr(), gpb,
            threads, mask, ck.lf.field_id)
        cudabuild.count("padd")
        cudabuild.count("padd_reduce")
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
