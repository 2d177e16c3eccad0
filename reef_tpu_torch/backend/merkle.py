"""Poseidon Merkle document commitment (the -m mode).

Mirrors reference src/backend/merkle_tree.rs: leaves hash (idx, char)
pairs two-at-a-time with an arity-4 absorb [li, lc, ri, rc]; inner nodes
absorb [left, right].  Path witnesses carry the sibling (and at the leaf
level the sibling's (idx, char)) plus a left/right flag.

The tree builds on the host (the batched device build is not part of this
package yet).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..ops import field as F
from ..ops.poseidon import HostSponge, IOPattern


def _hash(vals: List[int]) -> int:
    io = IOPattern([("absorb", len(vals)), ("squeeze", 1)])
    sp = HostSponge(F.FQ, io)
    sp.absorb([v % F.Q for v in vals])
    return sp.squeeze(1)[0]


@dataclass
class MerkleWit:
    l_or_r: bool            # True: lookup is the LEFT element
    opposite_idx: Optional[int]
    opposite: int


class MerkleCommitment:
    def __init__(self, udoc: List[int]):
        self.doc = [v % F.Q for v in udoc]
        tree: List[List[int]] = []
        level = []
        for i in range(0, len(self.doc), 2):
            li, lc = i, self.doc[i]
            if i + 1 < len(self.doc):
                ri, rc = i + 1, self.doc[i + 1]
            else:
                ri, rc = 0, 0
            level.append(_hash([li, lc, ri, rc]))
        tree.append(level)
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), 2):
                l = level[i]
                r = level[i + 1] if i + 1 < len(level) else 0
                nxt.append(_hash([l, r]))
            tree.append(nxt)
            level = nxt
        self.tree = tree
        self.commitment = level[0]

    @property
    def height(self) -> int:
        """Number of path witnesses per lookup (leaf + inner levels)."""
        return len(self.tree)

    def path_wits(self, idx: int) -> List[MerkleWit]:
        assert idx < len(self.doc)
        out = []
        if idx % 2 == 0:
            opp_i = idx + 1
            opp = self.doc[opp_i] if opp_i < len(self.doc) else 0
            out.append(MerkleWit(True, opp_i if opp_i < len(self.doc) else 0,
                                 opp))
        else:
            out.append(MerkleWit(False, idx - 1, self.doc[idx - 1]))
        quo = idx // 2
        for h in range(len(self.tree) - 1):
            if quo % 2 == 0:
                opp = (self.tree[h][quo + 1]
                       if quo + 1 < len(self.tree[h]) else 0)
                out.append(MerkleWit(True, None, opp))
            else:
                out.append(MerkleWit(False, None, self.tree[h][quo - 1]))
            quo //= 2
        return out

    def make_wits(self, lookups: List[int]) -> List[List[MerkleWit]]:
        return [self.path_wits(q) for q in lookups]

    def verify_path(self, idx: int, char: int, wits: List[MerkleWit]) -> bool:
        """Host-side path check (out-of-circuit oracle)."""
        w = wits[0]
        if w.l_or_r:
            h = _hash([idx, char, w.opposite_idx, w.opposite])
        else:
            h = _hash([w.opposite_idx, w.opposite, idx, char])
        for w in wits[1:]:
            h = _hash([h, w.opposite]) if w.l_or_r else _hash([w.opposite, h])
        return h == self.commitment
