"""Batched 255-bit Pasta field arithmetic on torch tensors.

Two layouts, both little-endian and limb-axis first, so one coordinate of a
batch of B elements is a (limbs, B) tensor whose limb rows are contiguous:

  - the device layout, (8, ...) int32: eight 32-bit limbs, each int32
    holding the bit pattern of a uint32.  The CUDA kernels (csrc/field.cuh)
    read and write this layout;
  - the plain layout, (16, ...) int64: sixteen 16-bit limbs.  The plain
    (pure torch) versions of the kernels compute in it.  Torch on the CPU
    has no uint32 add, shift, compare or searchsorted, and a 16x16-bit
    product summed 32 times still fits an int64 column with room to spare.

Montgomery form uses R = 2^256 in both layouts (the same R as
`field.HostField`), so a Montgomery integer is the same number whatever
the limb width; only the per-limb REDC factor differs (-p^-1 mod 2^16 for
the plain layout, mod 2^32 for the kernels).  Every result is canonical
(< p), so two implementations agree limb for limb.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import field as F

N = F.N_LIMBS          # 16 plain limbs
BITS = F.LIMB_BITS     # 16 bits each
MASK = F.LIMB_MASK
N32 = 8                # device-layout limbs of 32 bits


def _ints_to_words(xs: Sequence[int], dtype) -> np.ndarray:
    """(len(xs), 32 bytes / itemsize) little-endian words of each int."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype=dtype).reshape(len(xs), -1)


def _words_to_ints(arr: np.ndarray, bits: int) -> List[int]:
    """Inverse of `_ints_to_words` for a (n, limbs) array of `bits`-bit
    limbs (any integer dtype holding the limb's bit pattern)."""
    dt = np.uint16 if bits == 16 else np.uint32
    raw = np.ascontiguousarray(np.asarray(arr).astype(np.int64)
                               .astype(dt)).tobytes()
    return [int.from_bytes(raw[32 * i:32 * (i + 1)], "little")
            for i in range(len(raw) // 32)]


class LimbField:
    """Field context: modulus constants for both layouts, host encode and
    decode.  Hashable and immutable, one per field."""

    def __init__(self, host: F.HostField):
        self.host = host
        self.name = host.name
        self.p_int = host.p
        self.r_int = host.R                      # 2^256 mod p
        self.rinv_int = pow(host.R, -1, host.p)
        self.n0inv = host.n0inv                  # -p^-1 mod 2^16
        self.n0inv32 = (-pow(host.p, -1, 1 << 32)) % (1 << 32)
        self.p16 = [int(v) for v in F.to_limbs(host.p)]
        self.p32 = [(host.p >> (32 * i)) & 0xFFFFFFFF for i in range(N32)]
        self.field_id = 0 if host.p == F.P else 1   # csrc/field.cuh id
        self._consts: Dict[Tuple[str, str], torch.Tensor] = {}

    def __repr__(self):
        return f"LimbField({self.name})"

    # ---- host <-> tensor (python ints) -----------------------------------

    def mont(self, x: int) -> int:
        return int(x) % self.p_int * self.r_int % self.p_int

    def unmont(self, x: int) -> int:
        return int(x) * self.rinv_int % self.p_int

    def encode(self, xs: Sequence[int], device="cpu") -> torch.Tensor:
        """Python ints -> Montgomery (16, n) int64 plain-layout tensor."""
        w = _ints_to_words([self.mont(x) for x in xs], np.uint16)
        return torch.from_numpy(w.T.astype(np.int64)).to(device)

    def decode(self, t: torch.Tensor) -> List[int]:
        """(16, n) plain-layout Montgomery tensor -> python ints."""
        arr = t.detach().cpu().numpy().T
        return [self.unmont(x) for x in _words_to_ints(arr, 16)]

    def encode32(self, xs: Sequence[int], device="cpu") -> torch.Tensor:
        """Python ints -> Montgomery (8, n) int32 device-layout tensor."""
        w = mont_words(self, xs).view(np.int32)
        return torch.from_numpy(w.T.copy()).to(device)

    def decode32(self, t: torch.Tensor) -> List[int]:
        """(8, n) device-layout Montgomery tensor -> python ints."""
        arr = t.detach().cpu().numpy().T
        return [self.unmont(x) for x in _words_to_ints(arr, 32)]

    def const(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """A (16, 1, ..., 1) int64 constant broadcasting against `like`
        (p, or the Montgomery form of 3b = 15), cached per device."""
        key = (name, str(like.device))
        c = self._consts.get(key)
        if c is None:
            val = {"p": self.p_int, "b3": self.mont(15),
                   "one": self.r_int}[name]
            c = torch.tensor(F.to_limbs(val), dtype=torch.int64,
                             device=like.device)
            self._consts[key] = c
        return c.reshape((N,) + (1,) * (like.dim() - 1))


def mont_words(f: LimbField, xs: Sequence[int]) -> np.ndarray:
    """(len(xs), 8) uint32 limbs of each x's Montgomery form.  Runs the
    native host encoder (ops.native_fieldvec) where it is built, else
    python ints; values below 2^63 skip the python-int packing."""
    from . import native_fieldvec as FV
    if not FV.available():
        return _ints_to_words([f.mont(x) for x in xs], np.uint32)
    try:
        small = np.asarray(xs, dtype=np.int64).reshape(-1)
    except OverflowError:
        small = None
    if small is not None and (small >= 0).all():
        w = np.zeros((len(small), N32), np.uint32)
        w[:, 0] = small & 0xFFFFFFFF
        w[:, 1] = small >> 32
        raw = FV.to_mont_packed(w.tobytes(), f.p_int)
    else:
        raw = FV.to_mont(xs, f.p_int)
    return np.frombuffer(raw, dtype=np.uint32).reshape(len(xs), N32)


FP = LimbField(F.FP)
FQ = LimbField(F.FQ)


# ---------------------------------------------------------------------------
# layout conversion
# ---------------------------------------------------------------------------

def split32(t: torch.Tensor) -> torch.Tensor:
    """(8, ...) int32 device layout -> (16, ...) int64 plain layout."""
    w = t.to(torch.int64) & 0xFFFFFFFF
    out = torch.stack([w & MASK, w >> BITS], dim=1)       # (8, 2, ...)
    return out.reshape((N,) + tuple(t.shape[1:]))


def join16(t: torch.Tensor) -> torch.Tensor:
    """(16, ...) int64 plain layout (limbs < 2^16) -> (8, ...) int32."""
    pairs = t.reshape((N32, 2) + tuple(t.shape[1:]))
    w = pairs[:, 0] | (pairs[:, 1] << BITS)               # < 2^32
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


# ---------------------------------------------------------------------------
# plain modular ops on (16, ...) int64 tensors (inputs < p, outputs < p)
# ---------------------------------------------------------------------------

def _carry_(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries through non-negative columns in place -> 16-bit
    limbs; the top limb keeps what reaches it (the value must fit)."""
    c = torch.empty_like(t[0])
    for k in range(t.shape[0] - 1):
        torch.bitwise_right_shift(t[k], BITS, out=c)
        t[k].bitwise_and_(MASK)
        t[k + 1].add_(c)
    return t


def _borrow_(d: torch.Tensor) -> torch.Tensor:
    """Limb-wise differences (any sign, above -2^17) -> 16-bit limbs of
    their value mod 2^256, in place; returns 1 where the value is
    negative (the final borrow), else 0."""
    bor = torch.zeros_like(d[0])
    for k in range(N):
        d[k].sub_(bor)
        torch.lt(d[k], 0, out=bor)
        d[k].bitwise_and_(MASK)
    return bor


def cond_sub_p(f: LimbField, r: torch.Tensor) -> torch.Tensor:
    """r - p where r >= p, else r (r < 2^256, canonical limbs)."""
    d = r - f.const("p", r)
    return torch.where(_borrow_(d).bool(), r, d)


def add(f: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return cond_sub_p(f, _carry_(a + b))


def sub(f: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b, plus p where that borrowed (the sum wraps mod 2^256)."""
    d = a - b
    bor = _borrow_(d)
    d.addcmul_(f.const("p", d), bor)
    _carry_(d)[N - 1].bitwise_and_(MASK)
    return d


def neg(f: LimbField, a: torch.Tensor) -> torch.Tensor:
    return sub(f, torch.zeros_like(a), a)


def mul(f: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p: 32 schoolbook columns (each a
    sum of at most 16 products below 2^32), then `redc_cols`."""
    a, b = torch.broadcast_tensors(a, b)
    cols = torch.zeros((2 * N,) + tuple(a.shape[1:]), dtype=torch.int64,
                       device=a.device)
    for i in range(N):
        cols[i:i + N].addcmul_(b, a[i])
    return _redc_inplace(f, cols)


def redc_cols(f: LimbField, cols: torch.Tensor,
              subtracts: int = 2) -> torch.Tensor:
    """Montgomery-reduce (32, ...) non-negative column sums to a canonical
    (16, ...) element: 16 REDC rounds with n0inv, a carry pass and two
    conditional subtracts, as the JAX package's `limb.redc_cols` (or as
    many as `subtracts` says, where a caller's bound needs another count).

    The reference's contract: columns below 2^31 whose value is below
    ~5p^2, which the MXU Poseidon's byte matmul produces (ops/poseidon_mxu).
    Such a value can exceed p*R, so the REDC leaves up to ~2.3p and takes
    two subtracts.  Exact here also for a product's schoolbook columns
    (below ~2^40): the columns are int64."""
    return _redc_inplace(f, cols.clone(), subtracts)


def _redc_inplace(f: LimbField, cols: torch.Tensor,
                  subtracts: int = 1) -> torch.Tensor:
    """The REDC of `redc_cols` in place; one subtract suffices below p*R
    (a product of two values below p, as in `mul`)."""
    p = f.const("p", cols[:N])
    m = torch.empty_like(cols[0])
    for i in range(N):
        torch.mul(cols[i], f.n0inv, out=m)
        m.bitwise_and_(MASK)
        cols[i:i + N].addcmul_(p, m)
        torch.bitwise_right_shift(cols[i], BITS, out=m)
        cols[i + 1].add_(m)
    out = _carry_(cols[N:])
    for _ in range(subtracts):
        out = cond_sub_p(f, out)
    return out


def sqr(f: LimbField, a: torch.Tensor) -> torch.Tensor:
    return mul(f, a, a)


def pow5(f: LimbField, a: torch.Tensor) -> torch.Tensor:
    """a^5 (2 squarings + 1 mul) — the Poseidon S-box exponent."""
    a2 = mul(f, a, a)
    return mul(f, mul(f, a2, a2), a)
