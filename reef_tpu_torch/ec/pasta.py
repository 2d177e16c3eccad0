"""Pasta curves (Pallas/Vesta), host-side: y^2 = x^3 + 5.

Pallas: base field F_P, scalar field F_Q;  Vesta: base F_Q, scalar F_P
(the reference's G1/G2, framework.rs:1-2).  Both share the generator
(-1, 2).  Pedersen/Hyrax generator points are derived deterministically by
try-and-increment hash-to-curve from a label (the reference's nova fork uses
its own from_uniform_bytes derivation; only self-consistency matters — the
verifier derives the same generators from the same labels).

Points are affine tuples (x, y) with None for the identity.  This module is
the correctness oracle + the protocol-math path for small operations; the
batched device MSM lives in ec.msm_v3.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

from ..ops import field as F

B = 5
Point = Optional[Tuple[int, int]]  # None = identity


class Curve:
    def __init__(self, p: int, order: int, name: str):
        self.p = p
        self.order = order
        self.name = name
        self.gen: Point = (p - 1, 2)

    # ---- field helpers -------------------------------------------------

    def sqrt(self, a: int) -> Optional[int]:
        """Tonelli-Shanks (both pasta primes have 2-adicity 32).

        Returns SOME root (callers normalize parity / min themselves);
        routed through the native batch kernel when available — the
        verifier decompresses ~100 proof points, each costing a python
        Tonelli (~80us) otherwise."""
        p = self.p
        a %= p
        try:
            from .native_msm import sqrt_batch
            res = sqrt_batch(self, [a])
            if res is not None:
                return res[0]
        except Exception:
            pass
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        # p - 1 = q * 2^s
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        # find a non-residue
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t = t * c % p
            r = r * b % p
        return r

    def on_curve(self, pt: Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + B)) % self.p == 0

    # ---- group ops -----------------------------------------------------

    def add(self, a: Point, b: Point) -> Point:
        p = self.p
        if a is None:
            return b
        if b is None:
            return a
        x1, y1 = a
        x2, y2 = b
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1) * pow(2 * y1, p - 2, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def neg(self, a: Point) -> Point:
        if a is None:
            return None
        return (a[0], (-a[1]) % self.p)

    def double(self, a: Point) -> Point:
        return self.add(a, a)

    def mul(self, k: int, a: Point) -> Point:
        k %= self.order
        if k.bit_length() > 32 and a is not None:
            try:
                from .native_msm import msm_native
                return msm_native(self, [k], [a])
            except RuntimeError:
                pass
        return self._mul_py(k, a)

    def _mul_py(self, k: int, a: Point) -> Point:
        k %= self.order
        out: Point = None
        add = self.add
        while k:
            if k & 1:
                out = add(out, a)
            a = add(a, a)
            k >>= 1
        return out

    def msm(self, scalars: List[int], points: List[Point]) -> Point:
        """MSM: native C++ Pippenger when available, python fallback."""
        assert len(scalars) == len(points)
        n = len(scalars)
        if n == 0:
            return None
        try:
            from .native_msm import msm_native
            return msm_native(self, scalars, points)
        except RuntimeError:
            pass
        return self._msm_py(scalars, points)

    def _msm_py(self, scalars: List[int], points: List[Point]) -> Point:
        """Pure-python Pippenger (oracle / fallback)."""
        n = len(scalars)
        c = 4 if n < 32 else max(4, n.bit_length() - 2)
        c = min(c, 16)
        nbits = self.order.bit_length()
        windows = (nbits + c - 1) // c
        result: Point = None
        for w in reversed(range(windows)):
            if result is not None:
                for _ in range(c):
                    result = self.double(result)
            buckets: List[Point] = [None] * ((1 << c) - 1)
            for s, pt in zip(scalars, points):
                digit = (s >> (w * c)) & ((1 << c) - 1)
                if digit:
                    buckets[digit - 1] = self.add(buckets[digit - 1], pt)
            running: Point = None
            acc: Point = None
            for bkt in reversed(buckets):
                running = self.add(running, bkt)
                acc = self.add(acc, running)
            result = self.add(result, acc)
        return result

    # ---- generator derivation -------------------------------------------

    def hash_to_curve(self, label: bytes) -> Point:
        """Deterministic try-and-increment from SHA256(label || ctr)."""
        i = 0
        while True:
            h = hashlib.sha256(self.name.encode() + b"/" + label
                               + i.to_bytes(4, "big")).digest()
            x = int.from_bytes(h, "big") % self.p
            rhs = (x * x * x + B) % self.p
            y = self.sqrt(rhs)
            if y is not None:
                y = min(y, self.p - y)  # normalize parity choice
                pt = (x, y)
                if self.on_curve(pt):
                    return pt
            i += 1

    def gens(self, label: bytes, n: int) -> List[Point]:
        return [self.hash_to_curve(label + b"/" + i.to_bytes(8, "big"))
                for i in range(n)]

    # ---- compression ----------------------------------------------------

    def compress(self, pt: Point) -> Tuple[int, int]:
        """(x, sign_bit); identity = (0, 2)."""
        if pt is None:
            return (0, 2)
        x, y = pt
        return (x, y & 1)

    def decompress(self, comp: Tuple[int, int]) -> Point:
        """Strict decompression of untrusted bytes: rejects (VerifyError)
        non-canonical x >= p, unknown flags, and non-residue x — a malformed
        point in a proof must be a clean reject, not a crash (the round-1
        assert here was an AssertionError DoS on the verifier)."""
        from ..errors import VerifyError
        if (not isinstance(comp, (tuple, list)) or len(comp) != 2
                or not all(isinstance(v, int) for v in comp)):
            raise VerifyError("malformed compressed point")
        x, flag = comp
        if flag == 2:
            if x != 0:
                raise VerifyError("non-canonical identity encoding")
            return None
        if flag not in (0, 1):
            raise VerifyError("bad point parity flag")
        if not (0 <= x < self.p):
            raise VerifyError("point x out of field range")
        y = self.sqrt((x * x * x + B) % self.p)
        if y is None:
            raise VerifyError("x not on curve")
        if y & 1 != flag:
            y = self.p - y
        return (x, y)


# Pallas: points (x,y) in F_P, |group| = Q.  Vesta: coords in F_Q, order P.
PALLAS = Curve(F.P, F.Q, "pallas")
VESTA = Curve(F.Q, F.P, "vesta")
