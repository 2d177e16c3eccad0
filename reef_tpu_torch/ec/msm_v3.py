"""Device Pippenger MSM: byte windows, sorted buckets, pairwise-sum tree.

Port of the JAX package's ec/msm_v3.py.  The algorithm is the same; the
point arithmetic runs in two hand-written CUDA kernels, and the glue
between them is torch ops, as it was XLA ops on the TPU:

  per chunk of `cap` basis points, for each of the 32 byte windows (c = 8)
    1. sort the lanes by digit (keys digit<<20 | lane), descending;
    2. count the lanes with digit >= d for d = 1..255 (searchsorted);
    3. gather the sorted points and build the pairwise-sum tree over them
       (K2, csrc/msm_tree.cu, when cap >= 4096; else one K1 launch per
       level);
    4. assemble each digit's boundary prefix, the sum of the first
       count(>= d) sorted points, from at most log2(cap)+1 tree nodes
       (a Fenwick decomposition: one gather, then a pairwise reduce over
       the level axis with K1, csrc/padd.cu);
  then add the prefixes across chunks, sum them over the digit axis by
  masked halving (the Pippenger identity sum_d d*B_d = sum_{d>=1}
  prefix[count(>=d)-1]), and combine the 32 window sums on the host.

The reference places points in bit-reversed order so that the TPU kernel
pairs contiguous slices; here the tree pairs adjacent nodes in natural
order (node k of level b covers sorted points [k 2^b, (k+1) 2^b)), which
adds the same pairs, so the Fenwick indices need no bit reversal.

Points are (3, 8, ...) int32 device-layout arrays (ops.limb, ec.msm).
"""

from __future__ import annotations

import os
from typing import Callable, List

import numpy as np
import torch

from ..ops import limb
from ..utils import cudabuild
from ..utils.device import resolve
from .msm import CurveKernels
from .padd import limb_join, limb_split, padd_soa
from .msm import padd as _padd16, padd_affine as _padd_affine16
from .pasta import Point

WINDOW_C = 8
N_WINDOWS = 32            # 32 LE bytes cover the 255-bit scalars
D = 255                   # digits 1..255 have bucket boundaries
DP = 256                  # padded digit axis
TREE_MIN_CAP = 4096       # the tree kernel runs for chunks this wide
TREE_LEVELS_PER_PASS = 8  # levels one K2 launch builds (2^8 nodes a block)

PaddFn = Callable[[CurveKernels, torch.Tensor, torch.Tensor], torch.Tensor]


def scalars_to_bytes(scalars: List[int], order_mod: int) -> np.ndarray:
    """(n, 32) uint8 little-endian scalar bytes (the per-call upload)."""
    buf = b"".join((int(s) % order_mod).to_bytes(32, "little")
                   for s in scalars)
    return np.frombuffer(buf, np.uint8).reshape(len(scalars), 32).copy()


def default_cap() -> int:
    """Per-chunk point count (REEF_DEVICE_MSM_CHUNK, a power of two)."""
    cap = int(os.environ.get("REEF_DEVICE_MSM_CHUNK", "16384"))
    return max(128, 1 << (cap - 1).bit_length())


def level_offsets(cap: int) -> List[int]:
    """Lane offset of tree level b (b = 1..log2 cap) in a window's row of
    the tree array; entry 0 is unused (level 0 is the basis itself)."""
    log = cap.bit_length() - 1
    return [0] + [cap - (cap >> (b - 1)) for b in range(1, log + 1)]


# ---------------------------------------------------------------------------
# K2: the pairwise-sum tree
# ---------------------------------------------------------------------------

def _check_placed(placed: torch.Tensor) -> None:
    if placed.dtype != torch.int32:
        raise TypeError(f"placed: dtype {placed.dtype}, expected int32")
    if (placed.dim() != 4 or placed.shape[0] != 2
            or placed.shape[1] != limb.N32):
        raise ValueError(f"placed: shape {tuple(placed.shape)}, expected "
                         f"(2, {limb.N32}, W, cap)")
    cap = placed.shape[3]
    if cap < 2 or cap & (cap - 1):
        raise ValueError(f"placed: cap {cap} is not a power of two >= 2")
    if not placed.is_contiguous():
        raise ValueError("placed: not contiguous")


def tree_levels_plain(ck: CurveKernels, placed: torch.Tensor) -> torch.Tensor:
    """The tree kernel's plain version, on any device: (2, 8, W, cap)
    affine sorted points -> (3, 8, W, cap) levels 1..log2 cap at
    `level_offsets(cap)` (the last lane is unused and zero)."""
    _, _, W, cap = placed.shape
    out = torch.zeros((3, limb.N32, W, cap), dtype=torch.int32,
                      device=placed.device)
    x = limb_split(placed)
    cur = _padd_affine16(ck, x[..., 0::2], x[..., 1::2])
    out[..., :cap // 2] = limb_join(cur)
    off, w = cap // 2, cap // 2
    while w > 1:
        cur = _padd16(ck, cur[..., 0::2], cur[..., 1::2])
        out[..., off:off + w // 2] = limb_join(cur)
        off += w // 2
        w //= 2
    return out


def tree_levels(ck: CurveKernels, placed: torch.Tensor) -> torch.Tensor:
    """All tree levels of every window; K2 on a CUDA tensor, the plain
    version on a CPU tensor.  One launch per TREE_LEVELS_PER_PASS levels
    (two for cap = 4096 .. 65536)."""
    _check_placed(placed)
    if placed.device.type == "cpu":
        return tree_levels_plain(ck, placed)
    if placed.device.type != "cuda":
        raise ValueError(f"tree_levels: unsupported device {placed.device}")
    _, _, W, cap = placed.shape
    out = torch.empty((3, limb.N32, W, cap), dtype=torch.int32,
                      device=placed.device)
    log = cap.bit_length() - 1
    lib = cudabuild.library("msm_tree")
    stream = torch.cuda.current_stream(placed.device).cuda_stream
    lvl = 0
    while lvl < log:
        n = min(TREE_LEVELS_PER_PASS, log - lvl)
        err = lib.reef_tree_pass(placed.data_ptr(), out.data_ptr(), W, cap,
                                 lvl, n, ck.lf.field_id, stream)
        cudabuild.check(err, "reef_tree_pass")
        cudabuild.count("msm_tree")
        lvl += n
    return out


# ---------------------------------------------------------------------------
# the chunk pipeline
# ---------------------------------------------------------------------------

def _padd_nd(ck: CurveKernels, padd: PaddFn, A: torch.Tensor,
             B: torch.Tensor) -> torch.Tensor:
    """Point add on (3, 8, ...) arrays of any batch shape through a
    (3, 8, B) point-add function."""
    shape = A.shape
    out = padd(ck, A.reshape(3, limb.N32, -1).contiguous(),
               B.reshape(3, limb.N32, -1).contiguous())
    return out.reshape(shape)


def chunk_prefixes(ck: CurveKernels, pts: torch.Tensor, scb: torch.Tensor,
                   acc: torch.Tensor, use_tree: bool,
                   padd: PaddFn = padd_soa,
                   tree=tree_levels) -> torch.Tensor:
    """acc (3, 8, W, DP) + this chunk's boundary prefix sums.

    pts (3, 8, cap) int32 basis chunk; scb (cap, 32) uint8 scalar bytes.
    `padd` and `tree` are the kernels' wrappers, or their plain versions
    (to time the plain pipeline on the card)."""
    dev = pts.device
    cap = pts.shape[2]
    log = cap.bit_length() - 1
    W = N_WINDOWS

    digs = scb.t().to(torch.int64)                         # (W, cap)
    lanes = torch.arange(cap, dtype=torch.int64, device=dev)
    keys, _ = torch.sort((digs << 20) | lanes, dim=1)      # ascending
    order_desc = (keys & 0xFFFFF).flip(1)                  # (W, cap)
    dvals = torch.arange(1, DP + 1, dtype=torch.int64, device=dev)
    dvals = dvals.expand(W, DP).contiguous()
    c_ge = cap - torch.searchsorted((keys >> 20).contiguous(), dvals,
                                    side="left")
    m = torch.where(dvals <= D, c_ge, 0)                   # (W, DP)

    offs = level_offsets(cap)
    if use_tree:
        placed = pts[:2][:, :, order_desc].contiguous()    # (2, 8, W, cap)
        flat = tree(ck, placed)                            # (3, 8, W, cap)
    else:
        flat = torch.zeros((3, limb.N32, W, cap), dtype=torch.int32,
                           device=dev)
        cur = pts[:, :, order_desc]                        # (3, 8, W, cap)
        w = cap
        for b in range(1, log + 1):
            cur = _padd_nd(ck, padd, cur[..., 0::2], cur[..., 1::2])
            w //= 2
            flat[..., offs[b]:offs[b] + w] = cur

    # Fenwick nodes of each count m: for every set bit b of m, node
    # ((m >> (b+1)) << (b+1)) >> b of level b; level 0 straight from the
    # basis through the sort order
    ident = ck.ident_t(dev)
    k0 = torch.clamp((m >> 1) << 1, max=cap - 1)
    g0 = pts[:, :, torch.gather(order_desc, 1, k0)]        # (3, 8, W, DP)
    idx = torch.stack([offs[b] + (((m >> (b + 1)) << (b + 1)) >> b)
                       for b in range(1, log + 1)], dim=1)  # (W, log, DP)
    g = torch.gather(flat, 3, idx.reshape(1, 1, W, log * DP)
                     .expand(3, limb.N32, W, log * DP))
    g = torch.cat([g0[:, :, :, None, :],
                   g.reshape(3, limb.N32, W, log, DP)], dim=3)
    bits = torch.arange(log + 1, device=dev)
    mask = ((m[:, None, :] >> bits[None, :, None]) & 1).bool()
    g = torch.where(mask, g, ident[:, :, None, None, None])
    L = 1 << log.bit_length()                              # pad to 2^k
    if L != log + 1:
        pad = ident[:, :, None, None, None].expand(3, limb.N32, W,
                                                   L - log - 1, DP)
        g = torch.cat([g, pad], dim=3)
    while L > 1:
        L //= 2
        g = _padd_nd(ck, padd, g[..., :L, :], g[..., L:, :])
    return _padd_nd(ck, padd, acc, g[..., 0, :])


def halve_digits(ck: CurveKernels, acc: torch.Tensor,
                 padd: PaddFn = padd_soa) -> torch.Tensor:
    """Sum the DP boundary prefixes of each window by masked halving:
    (3, 8, W, DP) -> (3, 8, W)."""
    shift = DP // 2
    while shift >= 1:
        acc = _padd_nd(ck, padd, acc[..., :shift], acc[..., shift:2 * shift])
        shift //= 2
    return acc[..., 0]


def msm_windows(ck: CurveKernels, basis: "DeviceBasisV3", scb: torch.Tensor,
                padd: PaddFn = padd_soa, tree=tree_levels) -> torch.Tensor:
    """Window sums (3, 8, W) of one MSM; scb (n2, 32) uint8 on the basis's
    device."""
    acc = ck.ident_t(basis.device)[:, :, None, None].expand(
        3, limb.N32, N_WINDOWS, DP).contiguous()
    use_tree = basis.all_z1 and basis.cap >= TREE_MIN_CAP
    scb = scb.reshape(basis.n_chunks, basis.cap, 32)
    for c in range(basis.n_chunks):
        acc = chunk_prefixes(ck, basis.arr[c], scb[c], acc, use_tree,
                             padd, tree)
    return halve_digits(ck, acc, padd)


def combine_windows(ck: CurveKernels, accs) -> Point:
    """Host combine: sum_w 2^{8w} * A_w.  accs (3, 8, W)."""
    cv = ck.curve
    arr = accs.detach().cpu().numpy() if torch.is_tensor(accs) else accs
    window_pts = ck.to_affine(np.transpose(arr, (2, 0, 1)))
    result: Point = None
    for w in reversed(range(N_WINDOWS)):
        for _ in range(WINDOW_C):
            result = cv.double(result)
        result = cv.add(result, window_pts[w])
    return result


class DeviceBasisV3:
    """Device-resident basis shaped (n_chunks, 3, 8, cap), uploaded once
    per generator set."""

    def __init__(self, ck: CurveKernels, points, cap: int = 0, device=None):
        self.ck = ck
        self.device = resolve(device)
        self.cap = cap or default_cap()
        if isinstance(points, list):
            points = ck.to_proj(points)
        points = np.asarray(points, dtype=np.int32)         # (n, 3, 8)
        self.n = points.shape[0]
        n2 = 1 << max(0, self.n - 1).bit_length() if self.n > 1 else 1
        n2 = max(n2, min(self.cap, 128))
        self.cap = min(self.cap, n2)
        if n2 != self.n:
            # pad with zero-scalar GENERATORS, not identities: padding
            # lanes never enter a boundary prefix (digit 0 < every
            # bucket), and an all-Z=1 basis lets the tree gather only
            # (X, Y) and use the 10-product affine first level
            gpad = ck.to_proj([ck.curve.gen])[0]
            pad = np.broadcast_to(gpad, (n2 - self.n, 3, limb.N32))
            points = np.concatenate([points, pad])
        one = ck.to_proj([ck.curve.gen])[0, 2]
        self.all_z1 = bool(np.all(points[:, 2] == one))
        self.n2 = n2
        self.n_chunks = n2 // self.cap
        soa = np.transpose(points, (1, 2, 0))               # (3, 8, n2)
        soa = soa.reshape(3, limb.N32, self.n_chunks, self.cap)
        soa = np.ascontiguousarray(np.transpose(soa, (2, 0, 1, 3)))
        self.arr = torch.from_numpy(soa).to(self.device)


def upload_scalars(basis: DeviceBasisV3, rows) -> torch.Tensor:
    """(R, n2, 32) uint8 little-endian bytes of each row's scalars on the
    basis's device; a row shorter than the basis is padded with zeros."""
    ck = basis.ck
    scb = np.zeros((len(rows), basis.n2, 32), np.uint8)
    for r, row in enumerate(rows):
        if len(row) > basis.n2:
            raise ValueError(f"{len(row)} scalars for a basis of {basis.n}")
        scb[r, :len(row)] = scalars_to_bytes(list(row), ck.curve.order)
    return torch.from_numpy(scb).to(basis.device)


def msm_device_v3(ck: CurveKernels, scalars: List[int], points) -> Point:
    """Full MSM; `points` is a DeviceBasisV3 (resident; the production
    shape) or a host list/array (uploaded per call)."""
    if not scalars:
        raise ValueError("empty MSM")
    if not isinstance(points, DeviceBasisV3):
        points = DeviceBasisV3(ck, points)
    scb = upload_scalars(points, [scalars])[0]
    return combine_windows(ck, msm_windows(ck, points, scb))


def msm_device_v3_rows(ck: CurveKernels, rows_scalars,
                       points) -> List[Point]:
    """R independent MSMs of the same resident basis (the Hyrax row
    commits); the row count is a runtime argument.  The 32-window
    combine (8 doublings and one add per window, most significant first)
    runs on the device for all rows at once."""
    if not isinstance(points, DeviceBasisV3):
        points = DeviceBasisV3(ck, points)
    R = len(rows_scalars)
    if R < 1:
        raise ValueError("no rows")
    scb = upload_scalars(points, rows_scalars)
    accs = torch.stack([msm_windows(ck, points, scb[r]) for r in range(R)],
                       dim=-1)                              # (3, 8, W, R)
    acc = ck.ident_t(points.device)[:, :, None].expand(
        3, limb.N32, R).contiguous()
    for w in reversed(range(N_WINDOWS)):
        for _ in range(WINDOW_C):
            acc = padd_soa(ck, acc, acc)
        acc = padd_soa(ck, acc, accs[:, :, w].contiguous())
    return ck.to_affine(acc.permute(2, 0, 1))

