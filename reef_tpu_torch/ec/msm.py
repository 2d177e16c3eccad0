"""Curve context and the plain complete point addition on torch tensors.

Points are projective (X:Y:Z) triples of Montgomery field elements; the
identity is (0:1:0).  Addition uses the COMPLETE formulas for short
Weierstrass a = 0 (Renes-Costello-Batina 2016, Algorithm 7), so it is
branch-free and handles the identity, doubling and P + (-P) alike.

Layouts (see ops.limb): the kernels and the MSM hold points as (3, 8, ...)
int32 (coordinate, 32-bit limb, batch); the plain arithmetic here holds
them as (3, 16, ...) int64 (coordinate, 16-bit limb, batch).  The host
form of a point array is (n, 3, 8) int32 numpy, point-major.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops import limb
from ..ops.limb import LimbField, _ints_to_words, _words_to_ints
from .pasta import Curve, Point


class CurveKernels:
    """Context for one curve: its base field and constants."""

    def __init__(self, curve: Curve, lf: LimbField):
        assert curve.p == lf.p_int
        self.curve = curve
        self.lf = lf
        one = np.asarray(_ints_to_words([lf.r_int], np.uint32)[0])
        self.ident = np.zeros((3, limb.N32), np.int32)     # (0 : 1 : 0)
        self.ident[1] = one.view(np.int32)
        self._ident_t = {}

    def __repr__(self):
        return f"CurveKernels({self.curve.name})"

    def ident_t(self, device) -> torch.Tensor:
        """The identity as a (3, 8) int32 tensor on `device` (cached)."""
        key = str(device)
        t = self._ident_t.get(key)
        if t is None:
            t = torch.from_numpy(self.ident).to(device)
            self._ident_t[key] = t
        return t

    # ---- host <-> tensor ------------------------------------------------

    def to_proj(self, pts: List[Point]) -> np.ndarray:
        """Affine host points -> (n, 3, 8) int32 Montgomery projective."""
        lf = self.lf
        n = len(pts)
        vals = []
        for pt in pts:
            if pt is None:
                vals += [0, 1, 0]
            else:
                vals += [pt[0], pt[1], 1]
        w = _ints_to_words([lf.mont(v) for v in vals], np.uint32)
        return w.view(np.int32).reshape(n, 3, limb.N32).copy()

    def to_affine(self, proj) -> List[Point]:
        """(n, 3, 8) (or one (3, 8)) projective array -> affine points."""
        arr = proj.detach().cpu().numpy() if torch.is_tensor(proj) \
            else np.asarray(proj)
        single = arr.ndim == 2
        if single:
            arr = arr[None]
        lf = self.lf
        p = self.curve.p
        ints = _words_to_ints(arr.reshape(-1, limb.N32), 32)
        out = []
        for i in range(arr.shape[0]):
            x, y, z = (lf.unmont(v) for v in ints[3 * i:3 * i + 3])
            if z == 0:
                out.append(None)
            else:
                zi = pow(z, p - 2, p)
                out.append((x * zi % p, y * zi % p))
        return out[0] if single else out

    def ident16(self, device) -> torch.Tensor:
        """The identity as a (3, 16) int64 plain-layout point."""
        return limb.split32(self.ident_t(device).T).T.contiguous()

    def to_plain(self, pts: List[Point], device="cpu") -> torch.Tensor:
        """Affine host points -> (3, 16, n) int64 plain-layout projective
        points on `device`."""
        w = torch.from_numpy(self.to_proj(pts)).permute(2, 1, 0)  # (8, 3, n)
        return limb.split32(w).transpose(0, 1).contiguous().to(device)

    def plain_to_affine(self, P: torch.Tensor) -> List[Point]:
        """(3, 16, n) plain-layout points -> affine points."""
        w = limb.join16(P.transpose(0, 1))                    # (8, 3, n)
        return self.to_affine(w.permute(2, 1, 0))


def _field_ops(ck: CurveKernels):
    """mul / add / sub of the curve's base field on (16, G, ...) stacks."""
    f = ck.lf
    return (lambda a, b: limb.mul(f, a, b), lambda a, b: limb.add(f, a, b),
            lambda a, b: limb.sub(f, a, b))


def _stack(*vals: torch.Tensor) -> torch.Tensor:
    """G (16, ...) elements -> one (16, G, ...) stack."""
    return torch.stack(vals, dim=1)


def padd(ck: CurveKernels, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Complete projective addition on (3, 16, ...) int64 plain-layout
    points.  The 14 Montgomery products come in four independent groups
    (3 + 3 + 2 + 6), each one `limb.mul` call on stacked operands, as in
    the JAX package's `pallas_ec.padd_tiles`; every result is canonical,
    so the grouping does not change it."""
    mul, add, sub = _field_ops(ck)
    X1, Y1, Z1 = P.unbind(0)
    X2, Y2, Z2 = Q.unbind(0)
    b3 = ck.lf.const("b3", X1).expand_as(X1)

    t0, t1, t2 = mul(_stack(X1, Y1, Z1), _stack(X2, Y2, Z2)).unbind(1)
    s = add(_stack(X1, Y1, X1, X2, Y2, X2), _stack(Y1, Z1, Z1, Y2, Z2, Z2))
    pair = add(_stack(t0, t1, t0), _stack(t1, t2, t2))
    t3, t4, t5 = sub(mul(s[:, :3], s[:, 3:]), pair).unbind(1)
    b3t2, Y3 = mul(_stack(b3, b3), _stack(t2, t5)).unbind(1)
    t0 = add(add(t0, t0), t0)                 # 3*t0
    Z3 = add(t1, b3t2)
    t1 = sub(t1, b3t2)
    q = mul(_stack(t4, t3, Y3, t1, t0, Z3),
            _stack(Y3, t1, t0, Z3, t3, t4)).unbind(1)
    X3 = sub(q[1], q[0])                      # t3*t1 - t4*Y3
    Y3, Z3 = add(_stack(q[3], q[5]), _stack(q[2], q[4])).unbind(1)
    return torch.stack([X3, Y3, Z3])


def pdouble(ck: CurveKernels, P: torch.Tensor) -> torch.Tensor:
    return padd(ck, P, P)


def padd_affine(ck: CurveKernels, A: torch.Tensor,
                B: torch.Tensor) -> torch.Tensor:
    """The same addition for two Z = 1 points given as (2, 16, ...) (X, Y):
    t2 = 1 and 3b*t2 = 3b are constants and two cross products collapse
    to additions, leaving 10 products in three groups (2 + 2 + 6), as in
    `pallas_ec.padd_affine_tiles`.  Returns (3, 16, ...)."""
    mul, add, sub = _field_ops(ck)
    X1, Y1 = A.unbind(0)
    X2, Y2 = B.unbind(0)
    b3 = ck.lf.const("b3", X1).expand_as(X1)

    t0, t1 = mul(_stack(X1, Y1), _stack(X2, Y2)).unbind(1)
    # t4 = (Y1+1)(Y2+1) - t1 - 1 and t5 = (X1+1)(X2+1) - t0 - 1
    t4, t5, sA, sB = add(_stack(Y1, X1, X1, X2),
                         _stack(Y2, X2, Y1, Y2)).unbind(1)
    m3, Y3 = mul(_stack(sA, b3), _stack(sB, t5)).unbind(1)
    t3 = sub(m3, add(t0, t1))
    t0 = add(add(t0, t0), t0)                 # 3*t0
    Z3 = add(t1, b3)                          # t1 + 3b (t2 = 1)
    t1 = sub(t1, b3)
    q = mul(_stack(t4, t3, Y3, t1, t0, Z3),
            _stack(Y3, t1, t0, Z3, t3, t4)).unbind(1)
    X3 = sub(q[1], q[0])
    Y3, Z3 = add(_stack(q[3], q[5]), _stack(q[2], q[4])).unbind(1)
    return torch.stack([X3, Y3, Z3])


def scalar_bits(scalars: List[int], nbits: int) -> np.ndarray:
    """(nbits, n) bool, row j the bit nbits-1-j of each scalar (MSB
    first); the scalars are reduced, below 2^256."""
    raw = b"".join(int(s).to_bytes(32, "big") for s in scalars)
    bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(-1, 32), axis=1)
    return np.ascontiguousarray(bits[:, 256 - nbits:].T.astype(bool))


def select_point(mask: torch.Tensor, P: torch.Tensor,
                 Q: torch.Tensor) -> torch.Tensor:
    """mask (...) bool: P where mask, else Q, on (3, 16, ...) points."""
    return torch.where(mask, P, Q)


def _point_add(ck: CurveKernels, device: torch.device):
    """The binary MSM's add of (3, 16, m) points: K1 (`padd.padd_soa`, on
    its (3, 8, m) int32 layout) on a CUDA device, the plain `padd` on
    the CPU."""
    if device.type == "cpu":
        return lambda P, Q: padd(ck, P, Q)
    from .padd import limb_join, limb_split, padd_soa   # imports this module
    return lambda P, Q: limb_split(padd_soa(ck, limb_join(P), limb_join(Q)))


def tree_reduce(ck: CurveKernels, pts: torch.Tensor) -> torch.Tensor:
    """(3, 16, n) -> (3, 16) sum by halving vector adds (n a power of 2)."""
    add = _point_add(ck, pts.device)
    n = pts.shape[-1]
    while n > 1:
        half = n // 2
        pts = add(pts[..., :half], pts[..., half:2 * half])
        n = half
    return pts[..., 0]


def msm_device(ck: CurveKernels, scalars: List[int], points,
               device=None) -> torch.Tensor:
    """The binary MSM: for each scalar bit, MSB first, double the
    accumulator and add the tree-reduced sum of the points whose bit is
    set (255 rounds of log2(n) + 2 point adds, each K1 on the card).
    `points` is a list of affine host points, or (3, 16, n) plain-layout
    points, which fix the device; a list goes to `device` (default: the
    engine device).  Returns the projective (3, 16) sum."""
    if isinstance(points, list):
        from ..utils.device import resolve
        points = ck.to_plain(points, resolve(device))
    n = len(scalars)
    if points.shape != (3, limb.N, n):
        raise ValueError(f"points: shape {tuple(points.shape)}, expected "
                         f"(3, {limb.N}, {n})")
    dev = points.device
    ident = ck.ident16(dev)
    n2 = 1 << max(0, n - 1).bit_length() if n > 1 else 1
    if n2 != n:
        pad = ident[:, :, None].expand(3, limb.N, n2 - n)
        points = torch.cat([points, pad], dim=2)
    order = ck.curve.order
    bits = scalar_bits([int(s) % order for s in scalars] + [0] * (n2 - n),
                       order.bit_length())
    bits = torch.from_numpy(bits).to(dev)
    ident_n = ident[:, :, None].expand(3, limb.N, n2)
    add = _point_add(ck, dev)
    acc = ident[:, :, None]
    for row in bits:
        tree = tree_reduce(ck, select_point(row, points, ident_n))
        acc = add(add(acc, acc), tree[..., None])
    return acc[..., 0]


_KERNELS = {}


def pallas_kernels() -> CurveKernels:
    if "pallas" not in _KERNELS:
        from .pasta import PALLAS
        _KERNELS["pallas"] = CurveKernels(PALLAS, limb.FP)
    return _KERNELS["pallas"]


def vesta_kernels() -> CurveKernels:
    if "vesta" not in _KERNELS:
        from .pasta import VESTA
        _KERNELS["vesta"] = CurveKernels(VESTA, limb.FQ)
    return _KERNELS["vesta"]


def kernels_for(curve: Curve) -> CurveKernels:
    return pallas_kernels() if curve.name == "pallas" else vesta_kernels()
