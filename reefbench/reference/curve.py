"""Plain Pallas arithmetic in Python integers: y^2 = x^3 + 5 over F_p,
a group of prime order q.

Points are affine (x, y) tuples, None the identity; sums run in Jacobian
coordinates (X, Y, Z), Z = 0 the identity.  Generators come from the
published try-and-increment derivation: SHA-256 of the curve's name,
"/", the label and a 4-byte big-endian counter, x reduced mod p, the
smaller of the two square roots.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Optional, Sequence, Tuple

P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
Q = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
B = 5
NAME = b"pallas"

Point = Optional[Tuple[int, int]]
Jac = Tuple[int, int, int]
INF: Jac = (1, 1, 0)


def _sqrt_setup(p: int):
    s, t = 0, p - 1
    while t % 2 == 0:
        s, t = s + 1, t // 2
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    return s, t, pow(z, t, p)


_S, _T, _C = _sqrt_setup(P)


def sqrt(a: int) -> Optional[int]:
    """A square root of a mod P (Tonelli-Shanks), None for a non-residue."""
    a %= P
    if a == 0:
        return 0
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    m, c, t, r = _S, _C, pow(a, _T, P), pow(a, (_T + 1) // 2, P)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % P, i + 1
        b = pow(c, 1 << (m - i - 1), P)
        m, c, t, r = i, b * b % P, t * b * b % P, r * b % P
    return r


def on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return 0 <= x < P and 0 <= y < P and (y * y - x * x * x - B) % P == 0


def hash_to_curve(label: bytes) -> Tuple[int, int]:
    i = 0
    while True:
        h = hashlib.sha256(NAME + b"/" + label + i.to_bytes(4, "big"))
        x = int.from_bytes(h.digest(), "big") % P
        y = sqrt(x * x * x + B)
        if y is not None:
            return x, min(y, P - y)
        i += 1


def compress(pt: Point) -> Tuple[int, int]:
    """(x, parity of y); the identity (0, 2)."""
    return (0, 2) if pt is None else (pt[0], pt[1] & 1)


def decompress(comp: Sequence[int]) -> Point:
    """The point of a compressed pair; ValueError for one off the curve
    or out of range."""
    x, flag = comp
    if flag == 2 and x == 0:
        return None
    if flag not in (0, 1) or not 0 <= x < P:
        raise ValueError("malformed compressed point")
    y = sqrt(x * x * x + B)
    if y is None:
        raise ValueError("no point with this x")
    return x, (y if y & 1 == flag else P - y)


@functools.lru_cache(maxsize=None)
def generators(label: bytes, n: int) -> Tuple[Tuple[int, int], ...]:
    return tuple(hash_to_curve(label + b"/" + i.to_bytes(8, "big"))
                 for i in range(n))


def to_jac(pt: Point) -> Jac:
    return INF if pt is None else (pt[0], pt[1], 1)


def to_affine(pt: Jac) -> Point:
    X, Y, Z = pt
    if Z == 0:
        return None
    zi = pow(Z, P - 2, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def double(pt: Jac) -> Jac:
    X, Y, Z = pt
    if Z == 0 or Y == 0:
        return INF
    a = X * X % P
    b = Y * Y % P
    c = b * b % P
    d = 2 * ((X + b) * (X + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return x3, (e * (d - x3) - 8 * c) % P, 2 * Y * Z % P


def add(p1: Jac, p2: Jac) -> Jac:
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if Z1 == 0:
        return p2
    if Z2 == 0:
        return p1
    z1z1, z2z2 = Z1 * Z1 % P, Z2 * Z2 % P
    u1, u2 = X1 * z2z2 % P, X2 * z1z1 % P
    s1, s2 = Y1 * Z2 * z2z2 % P, Y2 * Z1 * z1z1 % P
    h, r = (u2 - u1) % P, (s2 - s1) % P
    if h == 0:
        return double(p1) if r == 0 else INF
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return x3, (r * (v - x3) - s1 * hhh) % P, Z1 * Z2 * h % P


def mul(k: int, pt: Point) -> Jac:
    acc, base = INF, to_jac(pt)
    k %= Q
    while k:
        if k & 1:
            acc = add(acc, base)
        base = double(base)
        k >>= 1
    return acc


def msm(scalars: Sequence[int], points: Sequence[Point], c: int = 8) -> Jac:
    """sum_i scalars[i] * points[i], by buckets of c-bit windows."""
    scalars = [s % Q for s in scalars]
    pts = [to_jac(pt) for pt in points]
    bits = max([s.bit_length() for s in scalars] + [1])
    mask = (1 << c) - 1
    total = INF
    for w in reversed(range(0, bits, c)):
        for _ in range(c):
            total = double(total)
        buckets = [INF] * (1 << c)
        for s, pt in zip(scalars, pts):
            d = (s >> w) & mask
            if d:
                buckets[d] = add(buckets[d], pt)
        running, window = INF, INF
        for d in range(mask, 0, -1):
            running = add(running, buckets[d])
            window = add(window, running)
        total = add(total, window)
    return total
