"""SAFE Poseidon sponge: IO patterns + host duplex sponge (+ device forwards).

Role in the system (mirrors neptune 8.1 in the reference):
  - prover-side Fiat-Shamir sponge for the nlookup sumcheck
    (reference src/backend/r1cs.rs:2260-2310),
  - Merkle tree hashing (reference src/backend/merkle_tree.rs:25-104),
  - in-circuit sponge replay (reference src/backend/nova.rs:549-681) —
    the circuit gadget in backend.ec_gadgets mirrors THIS module's
    absorb/squeeze semantics, which is what makes proofs verify,
  - Nova's random oracle.

This module is host-only (python ints) and imports no torch.  The batched
device permutation lives in ops.poseidon_device; its public names
(`permute`, `permute_plain`, `hash_elems`, `tag_elem`) are forwarded
lazily via module `__getattr__`, so callers can use `poseidon.permute(...)`.
"""

from __future__ import annotations

import hashlib

from . import field as F
from .poseidon_constants import host_permutation

_DEVICE_NAMES = ("permute", "permute_plain", "hash_elems", "tag_elem",
                 "_device_consts")


def __getattr__(name):
    if name in _DEVICE_NAMES:
        from . import poseidon_device
        return getattr(poseidon_device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# ---------------------------------------------------------------------------
# SAFE IOPattern + sponge
# ---------------------------------------------------------------------------

class IOPattern:
    """SAFE-style IO pattern: list of ("absorb"|"squeeze", n) ops.

    The tag hashes the aggregated pattern (consecutive same-type ops merged)
    plus a domain separator; it initializes the capacity lane, binding the
    transcript shape — the same role as neptune's IOPattern
    (used by the reference at r1cs.rs:2263-2277 with mode-dependent patterns).
    """

    def __init__(self, ops, domain: bytes = b""):
        agg = []
        for kind, n in ops:
            assert kind in ("absorb", "squeeze") and n > 0
            if agg and agg[-1][0] == kind:
                agg[-1] = (kind, agg[-1][1] + n)
            else:
                agg.append((kind, n))
        self.ops = agg
        self.domain = domain

    def words(self):
        out = []
        for kind, n in self.ops:
            out.append((0x80000000 | n) if kind == "absorb" else n)
        return out

    def tag_int(self) -> int:
        h = hashlib.sha256()
        for w in self.words():
            h.update(w.to_bytes(4, "big"))
        h.update(self.domain)
        return int.from_bytes(h.digest()[:16], "big")


class HostSponge:
    """SAFE duplex sponge over python ints (host-side Fiat-Shamir).

    Semantics (mirrored exactly by the in-circuit gadget):
      state[0] = tag; absorb adds into state[1+pos]; squeeze reads
      state[1+pos]; a permutation fires when the rate (t-1) is exhausted or
      on an absorb->squeeze direction change.
    """

    RATE = 4
    T = 5

    def __init__(self, field: F.HostField, io: IOPattern,
                 rate: int = None):
        self.f = field
        self.io = io
        if rate is not None:
            self.RATE = rate            # instance override (t = rate + 1)
        self.state = [io.tag_int() % field.p] + [0] * self.RATE
        self.pos = 0
        self.squeezing = False

    def _permute(self):
        self.state = host_permutation(self.f.p, self.state)
        self.pos = 0

    def absorb(self, elems):
        if self.squeezing:
            # squeeze->absorb direction change: reset position, NO permute
            # (SAFE semantics; keeps one permutation per sumcheck round,
            # matching the reference's 288-constraints-per-sponge cost shape,
            # costs.rs:115-138)
            self.pos = 0
            self.squeezing = False
        for e in elems:
            if self.pos == self.RATE:
                self._permute()
            self.state[1 + self.pos] = (self.state[1 + self.pos] + e) % self.f.p
            self.pos += 1

    def squeeze(self, n: int) -> list[int]:
        if not self.squeezing:
            self._permute()
            self.squeezing = True
        out = []
        for _ in range(n):
            if self.pos == self.RATE:
                self._permute()
            out.append(self.state[1 + self.pos])
            self.pos += 1
        return out
