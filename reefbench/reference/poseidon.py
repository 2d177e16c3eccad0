"""Plain Poseidon over the Pasta fields, as the Poseidon paper's
reference parameter generation defines it, and the two hashes the
proofs and commitments carry.

Parameters: the S-box x^5, R_F = 8 full rounds, R_P partial rounds from
the paper's table for 255-bit fields at 128-bit security (56 at width
5); round constants from the 80-bit Grain LFSR seeded with (field 1,
S-box 0, n, t, R_F, R_P) and thirty ones, 160 bits discarded, bits
filtered in pairs (a 1 emits the next bit), n-bit candidates >= p
rejected; the MDS matrix the Cauchy matrix 1 / (i + (t + j)).  The
permutation runs in the plain order: constants, S-boxes (lane 0 alone in
a partial round), MDS.

The sponge is SAFE's duplex with rate 4: lane 0 starts at the IO
pattern's tag (the first 16 bytes of SHA-256 over each operation's
32-bit word, absorb n as 2^31 | n and squeeze n as n, consecutive
operations of a kind merged, then the domain), an absorb adds into
lanes 1.. and permutes before a fifth element, a squeeze permutes first.
"""

from __future__ import annotations

import functools
import hashlib
from typing import List, Sequence, Tuple

from . import curve

FULL_ROUNDS = 8
PARTIAL_ROUNDS = {5: 56}
RATE = 4


class Grain:
    """The 80-bit Grain LFSR; bit i of `state` is s_i, s_0 the oldest."""

    def __init__(self, n: int, t: int, r_f: int, r_p: int):
        bits = []
        for val, width in ((1, 2), (0, 4), (n, 12), (t, 12), (r_f, 10),
                           (r_p, 10)):
            bits += [(val >> i) & 1 for i in reversed(range(width))]
        bits += [1] * 30
        self.state = sum(b << i for i, b in enumerate(bits))
        for _ in range(160):
            self._raw()

    def _raw(self) -> int:
        s = self.state
        new = ((s >> 62) ^ (s >> 51) ^ (s >> 38) ^ (s >> 23) ^ (s >> 13)
               ^ s) & 1
        self.state = (s >> 1) | (new << 79)
        return new

    def bit(self) -> int:
        while True:
            if self._raw():
                return self._raw()
            self._raw()

    def element(self, p: int, n: int) -> int:
        while True:
            v = 0
            for _ in range(n):
                v = (v << 1) | self.bit()
            if v < p:
                return v


@functools.lru_cache(maxsize=None)
def params(p: int, t: int) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...],
                                                           ...]]:
    r_p = PARTIAL_ROUNDS[t]
    n = p.bit_length()
    grain = Grain(n, t, FULL_ROUNDS, r_p)
    rc = tuple(grain.element(p, n) for _ in range((FULL_ROUNDS + r_p) * t))
    mds = tuple(tuple(pow(i + t + j, -1, p) for j in range(t))
                for i in range(t))
    return rc, mds


def permute(p: int, state: Sequence[int]) -> List[int]:
    t = len(state)
    rc, mds = params(p, t)
    r_p, half = PARTIAL_ROUNDS[t], FULL_ROUNDS // 2
    s = [x % p for x in state]
    for rnd in range(FULL_ROUNDS + r_p):
        s = [(x + rc[rnd * t + i]) % p for i, x in enumerate(s)]
        if rnd < half or rnd >= half + r_p:
            s = [pow(x, 5, p) for x in s]
        else:
            s[0] = pow(s[0], 5, p)
        s = [sum(m * x for m, x in zip(row, s)) % p for row in mds]
    return s


def tag(ops: Sequence[Tuple[str, int]], domain: bytes) -> int:
    h = hashlib.sha256()
    merged: List[List] = []
    for kind, n in ops:
        if merged and merged[-1][0] == kind:
            merged[-1][1] += n
        else:
            merged.append([kind, n])
    for kind, n in merged:
        word = (1 << 31) | n if kind == "absorb" else n
        h.update(word.to_bytes(4, "big"))
    h.update(domain)
    return int.from_bytes(h.digest()[:16], "big")


def sponge_hash(p: int, elems: Sequence[int], domain: bytes) -> int:
    """Absorb `elems`, squeeze one element."""
    state = [tag((("absorb", len(elems)), ("squeeze", 1)), domain) % p]
    state += [0] * RATE
    pos = 0
    for e in elems:
        if pos == RATE:
            state, pos = permute(p, state), 0
        state[1 + pos] = (state[1 + pos] + e) % p
        pos += 1
    return permute(p, state)[1]


def hide(v: int, salt: int) -> int:
    """The hiding hash of a value and the commitment's salt, over F_q: the
    proof's public claim about the document."""
    return sponge_hash(curve.Q, [v % curve.Q, salt % curve.Q], b"hide")


def row_hash(rows: Sequence[curve.Point]) -> int:
    """The hash of the commitment's rows over F_p, each row compressed
    (`curve.compress`), reduced below 2^254 and then into F_q."""
    data = []
    for pt in rows:
        data += list(curve.compress(pt))
    out = sponge_hash(curve.P, data, b"doc_commit_hash")
    return out % (1 << 254) % curve.Q
