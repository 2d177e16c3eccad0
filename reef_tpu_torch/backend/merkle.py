"""Poseidon Merkle document commitment (the -m mode).

Mirrors reference src/backend/merkle_tree.rs: leaves hash (idx, char)
pairs two-at-a-time with an arity-4 absorb [li, lc, ri, rc]; inner nodes
absorb [left, right].  Path witnesses carry the sibling (and at the leaf
level the sibling's (idx, char)) plus a left/right flag.

Device path: `build_tree_device` builds the whole tree as log2(n) batched
Poseidon calls (ops.poseidon_device; K5 on a CUDA device), one per level;
the per-level hashes are embarrassingly parallel.  The host path is the
oracle.
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


def build_tree_device(udoc: List[int], device=None) -> int:
    """Batched tree build on the engine device; returns the root.

    The leaf level is one hash_elems over [i, c_i, i+1, c_{i+1}] (t = 5;
    an odd tail pairs with (0, 0)); each inner level is one permutation
    of [tag, left, right, 0, 0] (an odd level pads with a zero node)."""
    import numpy as np
    import torch

    from ..ops import limb, poseidon_device
    from ..utils.device import resolve

    lf = limb.FQ
    dev = resolve(device)
    n = len(udoc)
    if n == 0:
        raise ValueError("build_tree_device: empty document")
    doc = np.zeros(n + (n & 1), dtype=object)
    doc[:n] = [v % F.Q for v in udoc]
    idx = np.arange(0, n, 2, dtype=np.int64)
    ri = np.where(idx + 1 < n, idx + 1, 0)
    leaves = np.stack([idx, doc[0::2], ri, doc[1::2]])      # (4, n/2)
    flat = lf.encode32(leaves.reshape(-1).tolist(), dev)  # (8, 4 n/2)
    elems = flat.reshape(limb.N32, 4, -1).permute(1, 0, 2).contiguous()
    level = poseidon_device.hash_elems(lf, elems)            # (8, n/2)
    while level.shape[1] > 1:
        if level.shape[1] % 2:
            level = torch.cat([level, torch.zeros_like(level[:, :1])], dim=1)
        m = level.shape[1] // 2
        level = _device_hash2(lf, level.reshape(limb.N32, m, 2)
                              .permute(2, 0, 1))
    return lf.decode32(level)[0]


def _device_hash2(lf, pairs):
    """Batched inner-node hash of (2, 8, m) (left, right) rows -> (8, m):
    absorb 2, squeeze 1 (matches the host _hash), one permutation of
    [tag, left, right, 0, 0]."""
    import torch

    from ..ops import limb, poseidon_device

    io = IOPattern([("absorb", 2), ("squeeze", 1)])
    tag = poseidon_device.tag_elem(lf, io, pairs.device)
    m = pairs.shape[2]
    state = torch.cat([tag.expand(1, limb.N32, m), pairs,
                       torch.zeros((2, limb.N32, m), dtype=torch.int32,
                                   device=pairs.device)])
    return poseidon_device.permute(lf, state.contiguous())[1]
