"""The v2 Pippenger MSM: window digits sorted on the host, a pairwise-sum
tree and Fenwick prefixes on the device, the window combine on the host.

Port of the JAX package's ec/msm_pippenger.py.  Per MSM of n points with
c = 8-bit windows (W = 32 windows):

  host    1. the scalars' window digits (W, n);
          2. per window, a stable sort of the points by digit, descending,
             and for each digit d the count of points with digit >= d,
             decomposed over the levels of a pairwise-sum tree (Fenwick);
  device  3. gather the points into window order, (3, 16, W, n);
          4. build the tree (n - 1 adds in log2 n levels), assemble each
             digit's boundary prefix from at most log2 n + 1 tree nodes,
             and sum the 255 prefixes of a window by masked halving: by
             Pippenger's identity that is sum_d d * B_{w,d}
             (`window_kernel_v2_fn`);
  host    5. sum_w 2^{8w} * A_w over the W window points.

`window_kernel_fn` is the earlier body (a blocked Hillis-Steele prefix
scan), which the reference's mesh MSM runs on each device's shard.

All point arithmetic is the plain point add of ec/msm.py on (3, 16, ...)
int64 points.  On a CUDA device `msm_device` enables the field-kernel
hook (ops/field_kernel.py) for its run, so the add's Montgomery products
go to K3, and restores the caller's hook state afterwards, also when it
raises.  Batches are chunks of REEF_DEVICE_MSM_CHUNK points (default
8192), whose window points are accumulated with one point add each.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, List

import numpy as np
import torch

from ..ops import field_kernel, limb
from ..utils.device import resolve
from .msm import CurveKernels, padd
from .pasta import Point

WINDOW_C = 8
NBITS = 255
N_WINDOWS = (NBITS + WINDOW_C - 1) // WINDOW_C

Kernel = Callable[..., torch.Tensor]


def _digits_np(scalars: List[int], order_mod: int) -> np.ndarray:
    """(W, n) uint16 window digits via numpy byte tricks."""
    n = len(scalars)
    raw = np.zeros((n, 32), np.uint8)
    for i, s in enumerate(scalars):
        raw[i] = np.frombuffer((s % order_mod).to_bytes(32, "little"),
                               np.uint8)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, :NBITS + 1]
    digs = np.zeros((N_WINDOWS, n), np.uint16)
    for w in range(N_WINDOWS):
        chunk = bits[:, w * WINDOW_C:(w + 1) * WINDOW_C]
        digs[w] = (chunk * (1 << np.arange(chunk.shape[1],
                                           dtype=np.uint16))).sum(axis=1)
    return digs


def _sorted_digit_counts(scalars: List[int], order_mod: int, n: int):
    """Per-window descending-digit stable sort order (W, n) and the
    counts c_ge[w, d] = #points with digit >= d."""
    digs = _digits_np(scalars, order_mod)
    order = np.zeros((N_WINDOWS, n), np.int32)
    c_ge_all = np.zeros((N_WINDOWS, 1 << WINDOW_C), np.int64)
    for w in range(N_WINDOWS):
        order[w] = np.argsort(-digs[w].astype(np.int32), kind="stable")
        counts = np.bincount(digs[w], minlength=1 << WINDOW_C)
        c_ge_all[w] = np.cumsum(counts[::-1])[::-1]
    return order, c_ge_all


def window_prep(scalars: List[int], order_mod: int, n: int):
    """Host prep of the prefix-scan kernel: (order (W, n) int32,
    bnd_idx (W, D) int32, bnd_mask (W, D) bool), D = 255."""
    D = (1 << WINDOW_C) - 1
    order, c_ge_all = _sorted_digit_counts(scalars, order_mod, n)
    bnd_idx = np.zeros((N_WINDOWS, D), np.int32)
    bnd_mask = np.zeros((N_WINDOWS, D), bool)
    for w in range(N_WINDOWS):
        c_ge = c_ge_all[w]
        for d in range(1, D + 1):
            cnt = int(c_ge[d])
            bnd_idx[w, d - 1] = max(cnt - 1, 0)
            bnd_mask[w, d - 1] = cnt > 0
    return order, bnd_idx, bnd_mask


def window_prep_v2(scalars: List[int], order_mod: int, n: int):
    """Host prep of the tree + Fenwick kernel: the sort order and, for
    every (window, digit) count m = #points with digit >= d, the tree
    nodes whose sum is the prefix of the first m sorted points: for each
    set bit b of m, node (m with bits <= b cleared) >> b of level b.
    Level b (width n >> b) sits at offset off_b of the flat level array,
    off_0 = 0, off_b = off_{b-1} + (n >> (b-1)).  Returns (order (W, n),
    lv_idx (LV, W, 256) int32, lv_mask (LV, W, 256) bool); the digit axis
    is padded from 255 to 256 with False masks, as the reference pads it
    to whole 128-lane rows."""
    D = (1 << WINDOW_C) - 1
    LV = max(1, (n - 1).bit_length()) + 1          # levels 0..log2(n)
    order, c_ge_all = _sorted_digit_counts(scalars, order_mod, n)
    counts_m = c_ge_all[:, 1:]                     # m for digits 1..D
    offs = np.zeros(LV, np.int64)
    width = n
    for b in range(1, LV):
        offs[b] = offs[b - 1] + width
        width //= 2
    Dp = D + 1
    lv_idx = np.zeros((LV, N_WINDOWS, Dp), np.int32)
    lv_mask = np.zeros((LV, N_WINDOWS, Dp), bool)
    for b in range(LV):
        bit = (counts_m >> b) & 1
        lv_mask[b, :, :D] = bit.astype(bool)
        cleared = (counts_m >> (b + 1)) << (b + 1)  # clear bits <= b
        lv_idx[b, :, :D] = (offs[b] + (cleared >> b)).astype(np.int32)
    return order, lv_idx, lv_mask


def _gather(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals (3, 16, W, m), idx (W, D) -> (3, 16, W, D)."""
    return vals.gather(3, idx.expand(vals.shape[:2] + idx.shape))


def _halve_sum(ck: CurveKernels, acc: torch.Tensor,
               ident: torch.Tensor) -> torch.Tensor:
    """(3, 16, W, D) -> (3, 16, W): the sum over the last axis by masked
    halving, padded to a power of two with identities."""
    D = acc.shape[3]
    D2 = 1 << max(0, (D - 1).bit_length())
    if D2 != D:
        pad = ident[:, :, None, None].expand(acc.shape[:3] + (D2 - D,))
        acc = torch.cat([acc, pad], dim=3)
    pos = torch.arange(D2, device=acc.device)
    shift = D2 // 2
    while shift:
        summed = padd(ck, acc, torch.roll(acc, -shift, dims=3))
        acc = torch.where(pos < shift, summed, acc)
        shift //= 2
    return acc[..., 0]


def window_kernel_fn(ck: CurveKernels, n: int) -> Kernel:
    """The prefix-scan window kernel: kernel(pts (3, 16, n), order (W, n),
    bnd_idx (W, D), bnd_mask (W, D), ident (3, 16)) -> (3, 16, W).
    Inclusive prefix sums of the sorted points by Hillis-Steele within
    groups of G = 16, then over the group totals; each boundary prefix is
    its group's prefix plus the group's exclusive offset."""
    G = 16 if n >= 256 else n
    ng = n // G

    def hs_prefix(vals: torch.Tensor, axis: int) -> torch.Tensor:
        length = vals.shape[axis]
        pos = torch.arange(length, device=vals.device).reshape(
            [length if a == axis else 1 for a in range(vals.dim())])
        shift = 1
        while shift < length:
            summed = padd(ck, vals, torch.roll(vals, shift, dims=axis))
            vals = torch.where(pos >= shift, summed, vals)
            shift *= 2
        return vals

    def kernel(pts, order, bnd_idx, bnd_mask, ident):
        W = order.shape[0]
        sorted_pts = pts[:, :, order]                       # (3, 16, W, n)
        in_grp = hs_prefix(sorted_pts.reshape(3, limb.N, W, ng, G), 4)
        part = _gather(in_grp.reshape(3, limb.N, W, n), bnd_idx)
        if ng > 1:
            incl = hs_prefix(in_grp[..., -1], 3)            # (3, 16, W, ng)
            excl = torch.cat([ident[:, :, None, None].expand(
                3, limb.N, W, 1), incl[..., :-1]], dim=3)
            part = padd(ck, part, _gather(excl, bnd_idx // G))
        part = torch.where(bnd_mask, part, ident[:, :, None, None])
        return _halve_sum(ck, part, ident)

    return kernel


def window_kernel_v2_fn(ck: CurveKernels, n: int) -> Kernel:
    """The tree + Fenwick window kernel: kernel(pts (3, 16, n),
    order (W, n), lv_idx (LV, W, D), lv_mask (LV, W, D), ident (3, 16))
    -> (3, 16, W).  About 32 n point-add lanes against the prefix scan's
    ~147 n."""

    def kernel(pts, order, lv_idx, lv_mask, ident):
        W, D = order.shape[0], lv_idx.shape[-1]
        cur = pts[:, :, order]                              # (3, 16, W, n)
        levels = [cur]
        while cur.shape[3] > 1:
            cur = padd(ck, cur[..., 0::2], cur[..., 1::2])
            levels.append(cur)
        flat = torch.cat(levels, dim=3)                     # (.., 2n - 1)
        # at n = 1 the prep names a level the tree lacks, always masked
        lv_idx = lv_idx.clamp(max=flat.shape[3] - 1)
        acc = ident[:, :, None, None].expand(3, limb.N, W, D)
        for idx, mask in zip(lv_idx, lv_mask):
            acc = torch.where(mask, padd(ck, acc, _gather(flat, idx)), acc)
        # empty boundaries never passed a mask and stay the identity
        return _halve_sum(ck, acc, ident)

    return kernel


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length() if n > 1 else 1


class DeviceBasis:
    """A fixed MSM basis kept on the device as (3, 16, n2) int64 points,
    n2 = n padded to a power of two with identities: upload once, then
    each MSM moves only its scalars' index arrays.  `points` is a list of
    affine host points or (3, 16, n) plain-layout points (which keep
    their device)."""

    def __init__(self, ck: CurveKernels, points, device=None):
        self.ck = ck
        if isinstance(points, list):
            points = ck.to_plain(points, resolve(device))
        n = points.shape[2]
        self.n = n
        self.n2 = _pow2(n)
        if self.n2 != n:
            pad = ck.ident16(points.device)[:, :, None].expand(
                3, limb.N, self.n2 - n)
            points = torch.cat([points, pad], dim=2)
        self.arr = points.contiguous()


def combine_windows(ck: CurveKernels, accs: torch.Tensor) -> Point:
    """Host combine of the (3, 16, W) window points: sum_w 2^{8w} A_w."""
    cv = ck.curve
    window_pts = ck.plain_to_affine(accs)
    result: Point = None
    for w in reversed(range(N_WINDOWS)):
        for _ in range(WINDOW_C):
            result = cv.double(result)
        result = cv.add(result, window_pts[w])
    return result


def _routes_to_kernels(device: torch.device) -> bool:
    """Whether an MSM on `device` sends its products to K3."""
    return device.type == "cuda"


def chunk_cap() -> int:
    """Points a kernel run takes (REEF_DEVICE_MSM_CHUNK, a power of two)."""
    cap = int(os.environ.get("REEF_DEVICE_MSM_CHUNK", "8192"))
    return max(2, 1 << (cap - 1).bit_length())


def msm_device(ck: CurveKernels, scalars: List[int], points,
               device=None) -> Point:
    """Full MSM; returns an affine host point (None for the identity).
    `points` is a list of affine host points (uploaded to `device`, by
    default the engine device) or a DeviceBasis (resident; shorter
    scalar lists are padded with zeros, which fall past every bucket
    boundary)."""
    n = len(scalars)
    if n < 1:
        raise ValueError("msm_device: no scalars")
    if not isinstance(points, DeviceBasis):
        points = DeviceBasis(ck, points, device)
    if n > points.n2:
        raise ValueError(f"msm_device: {n} scalars for a basis of "
                         f"{points.n2}")
    scalars = list(scalars) + [0] * (points.n2 - n)
    n = points.n2
    pts = points.arr
    # on the card the point adds' products go to K3 for this run only
    hook = field_kernel.enabled() if _routes_to_kernels(pts.device) \
        else contextlib.nullcontext()
    with hook:
        cap = chunk_cap()
        if n <= cap:
            accs = _msm_accs(ck, scalars, pts)
        else:
            accs = None
            for k in range(n // cap):      # n and cap are powers of two
                sl = slice(k * cap, (k + 1) * cap)
                a = _msm_accs(ck, scalars[sl], pts[..., sl])
                accs = a if accs is None else padd(ck, accs, a)
    return combine_windows(ck, accs)


def _msm_accs(ck: CurveKernels, scalars: List[int],
              pts: torch.Tensor) -> torch.Tensor:
    """The (3, 16, W) window points of one kernel-sized MSM."""
    n = pts.shape[2]
    order, lv_idx, lv_mask = window_prep_v2(scalars, ck.curve.order, n)
    dev = pts.device
    kern = window_kernel_v2_fn(ck, n)
    return kern(pts, torch.from_numpy(order).long().to(dev),
                torch.from_numpy(lv_idx).long().to(dev),
                torch.from_numpy(lv_mask).to(dev), ck.ident16(dev))
