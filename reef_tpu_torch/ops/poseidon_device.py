"""Batched Poseidon on torch tensors (the device side of ops/poseidon.py).

The port of the JAX package's ops/poseidon_device.py.  A batch of B states
of width t is a (t, 8, B) int32 tensor in the kernels' layout (ops.limb):
lane l of every state is one (8, B) field row, Montgomery form.
`permute` is the batched permutation and K5's wrapper: on a CUDA tensor
it launches K5 (ops/poseidon_kernel.py, csrc/poseidon.cu) for every batch
size, down to the single sponge state of a sumcheck round, by the launch
`poseidon_kernel.route` picks; on a CPU tensor it runs `permute_plain`,
the same rounds in plain torch on 16-bit limbs.  The reference keeps a
`lax.scan` for batches below one Pallas block (1024 states); here a plain
torch permutation on the card would cost a hundred thousand launches, so
the kernel serves every size.

Width t = 5 (arity 4) hashes Merkle nodes; t = 9 (rate 8) is the nlookup
Fiat-Shamir sponge (backend/costs.py NL_RATE).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import limb, poseidon_kernel
from .limb import LimbField
from .poseidon import IOPattern
from .poseidon_constants import (FULL_ROUNDS, PARTIAL_ROUNDS,
                                  poseidon_params, sparse_params)


@functools.lru_cache(maxsize=None)
def _device_consts(lf: LimbField, t: int) -> Tuple[np.ndarray, np.ndarray]:
    """Round constants (n_rounds, t, 8) and MDS (t, t, 8), Montgomery, as
    uint32 words of 32-bit limbs (the block-per-state launch's tables)."""
    rc, mds = poseidon_params(lf.p_int, t)
    n_rounds = FULL_ROUNDS + PARTIAL_ROUNDS[t]
    rc_w = limb.mont_words(lf, rc).reshape(n_rounds, t, limb.N32)
    mds_w = limb.mont_words(lf, [m for row in mds for m in row])
    return rc_w, mds_w.reshape(t, t, limb.N32)


@functools.lru_cache(maxsize=None)
def _sparse_consts(lf: LimbField, t: int) -> Dict[str, np.ndarray]:
    """`sparse_params` as Montgomery uint32 words (..., 8): full_rc (R_F,
    t), pre and mds (t, t), and per partial round its lane-0 constant,
    its row and its column as one (R_P, 2 t) block `part` (constant,
    row[0..t), cols[0..t-1)): the thread-per-state launch's tables."""
    full_rc, part_rc, pre, mds, rows, cols = sparse_params(lf.p_int, t)

    def words(xs, *shape):
        flat = [x for row in xs for x in row]
        return limb.mont_words(lf, flat).reshape(*shape, limb.N32)
    part = [(c, *r, *k) for c, r, k in zip(part_rc, rows, cols)]
    return {"full_rc": words(full_rc, FULL_ROUNDS, t),
            "pre": words(pre, t, t), "mds": words(mds, t, t),
            "part": words(part, PARTIAL_ROUNDS[t], 2 * t)}


def sparse_table(lf: LimbField, t: int) -> np.ndarray:
    """The thread-per-state launch's tables as one flat uint32 array in
    the order of csrc/poseidon.cu's `sparse_tables`: full_rc, pre, mds,
    part."""
    c = _sparse_consts(lf, t)
    return np.concatenate([c[k].reshape(-1) for k in
                           ("full_rc", "pre", "mds", "part")])


_PLAIN: Dict[Tuple[LimbField, int, str, bool], Tuple[torch.Tensor, ...]] = {}


def _plain16(words: np.ndarray, device) -> torch.Tensor:
    """(..., 8) uint32 words -> (16, ...) int64 plain limbs on device."""
    w = torch.from_numpy(words.view(np.int32).copy()).to(device)
    return limb.split32(w.movedim(-1, 0))


def _plain_consts(lf: LimbField, t: int, device: torch.device,
                  sparse: bool = False):
    """Dense: (rc (n_rounds, 16, t, 1), mds (16, t, t, 1)); sparse:
    (full_rc (R_F, 16, t, 1), pre, mds (16, t, t, 1), part_rc (R_P, 16, 1,
    1), rows (R_P, 16, 1, t, 1), cols (R_P, 16, t - 1, 1, 1)); int64 on
    `device`."""
    key = (lf, t, str(device), sparse)
    if key not in _PLAIN:
        if not sparse:
            rc_w, mds_w = _device_consts(lf, t)
            _PLAIN[key] = (_plain16(rc_w, device).movedim(0, 1)[..., None],
                           _plain16(mds_w, device)[..., None])
        else:
            c = _sparse_consts(lf, t)
            part = _plain16(c["part"], device).movedim(0, 1)  # (R_P, 16, 2t)
            _PLAIN[key] = (
                _plain16(c["full_rc"], device).movedim(0, 1)[..., None],
                _plain16(c["pre"], device)[..., None],
                _plain16(c["mds"], device)[..., None],
                part[:, :, :1, None], part[:, :, None, 1:t + 1, None],
                part[:, :, t + 1:, None, None])
        _PLAIN[key] = tuple(x.contiguous() for x in _PLAIN[key])
    return _PLAIN[key]


def row_subtracts(terms: int, high: bool = False) -> int:
    """Conditional subtracts after the REDC of a sum of `terms` products
    of values below p, plus a value below p times R where `high`.  As
    p < 2^254 (1 + 2^-125) = R (1 + 2^-125) / 4, that sum is below
    (terms / 4 + high) (1 + 2^-125) p R; the REDC adds less than p R and
    divides by R, which leaves it below (terms / 4 + high + 1 + 2^-120) p.
    (csrc/poseidon.cu's perm_kernel takes the same counts.)"""
    return terms // 4 + 1 + high


def _lazy_rows(lf: LimbField, s: torch.Tensor, m: torch.Tensor,
               high: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out_i = sum_j m[i][j] s_j (+ high_i R) on (16, t, B) int64 with m
    (16, r, t, 1): a row's products summed as 32 schoolbook columns (each
    below 2^40, high in the upper 16), then one REDC and
    `row_subtracts` conditional subtracts -> (16, r, B)."""
    t = s.shape[1]
    cols = torch.zeros((2 * limb.N, m.shape[1]) + tuple(s.shape[2:]),
                       dtype=torch.int64, device=s.device)
    for a in range(limb.N):
        cols[a:a + limb.N] += (m * s[a][None, None]).sum(dim=2)
    if high is not None:
        cols[limb.N:] += high
    return limb.redc_cols(lf, cols, row_subtracts(t, high is not None))


def _spread_round(lf: LimbField, s: torch.Tensor, rc: torch.Tensor,
                  mds: torch.Tensor, full: bool) -> torch.Tensor:
    """One round on (16, t, B) int64 as csrc/poseidon.cu's
    perm_spread_kernel computes it: x = s + rc; the products
    (M_ij x_j) x_j^4 on the S-box lanes j and M_ij x_j on the others;
    then each row's t products summed by modular adds."""
    t = s.shape[1]
    x = limb.add(lf, s, rc)
    p = limb.mul(lf, mds, x[:, None])                    # (16, t, t, B)
    k = t if full else 1
    x2 = limb.mul(lf, x[:, :k], x[:, :k])
    p = torch.cat([limb.mul(lf, p[:, :, :k], limb.mul(lf, x2, x2)[:, None]),
                   p[:, :, k:]], dim=2)
    row = p[:, :, 0]
    for j in range(1, t):
        row = limb.add(lf, row, p[:, :, j])
    return row


def _permute16(lf: LimbField, s: torch.Tensor,
               spread: bool = False) -> torch.Tensor:
    """The permutation on a (16, t, B) int64 plain-layout batch; `spread`
    takes `_spread_round`'s arithmetic."""
    t = s.shape[1]
    rc, mds = _plain_consts(lf, t, s.device)
    half, r_p = FULL_ROUNDS // 2, PARTIAL_ROUNDS[t]
    for r in range(2 * half + r_p):
        full = r < half or r >= half + r_p
        if spread:
            s = _spread_round(lf, s, rc[r], mds, full)
            continue
        s = limb.add(lf, s, rc[r])
        if full:
            s = limb.pow5(lf, s)
        else:
            s = torch.cat([limb.pow5(lf, s[:, :1]), s[:, 1:]], dim=1)
        s = _lazy_rows(lf, s, mds)
    return s


def _permute16_sparse(lf: LimbField, s: torch.Tensor) -> torch.Tensor:
    """The permutation on a (16, t, B) int64 batch as csrc/poseidon.cu's
    perm_kernel computes it, on `sparse_params`' tables: each full round
    one lazy row a lane (`_lazy_rows`); each partial round the lane-0
    S-box, the lane-0 row, then s_i + c_i x0 on lanes i >= 1, each one
    product and s_i R summed before one REDC."""
    t = s.shape[1]
    full_rc, pre, mds, part_rc, rows, cols = _plain_consts(lf, t, s.device,
                                                           sparse=True)
    half = FULL_ROUNDS // 2
    for r in range(FULL_ROUNDS):
        if r == half:
            for k in range(PARTIAL_ROUNDS[t]):
                x0 = limb.pow5(lf, limb.add(lf, s[:, :1], part_rc[k]))
                s = torch.cat([x0, s[:, 1:]], dim=1)
                s = torch.cat([_lazy_rows(lf, s, rows[k]),
                               _lazy_rows(lf, x0, cols[k], high=s[:, 1:])],
                              dim=1)
        s = limb.pow5(lf, limb.add(lf, s, full_rc[r]))
        s = _lazy_rows(lf, s, pre if r == half - 1 else mds)
    return s


def _check_state(state: torch.Tensor) -> int:
    if state.dtype != torch.int32:
        raise TypeError(f"state: dtype {state.dtype}, expected torch.int32")
    if state.dim() != 3 or state.shape[1] != limb.N32:
        raise ValueError(f"state: shape {tuple(state.shape)}, expected "
                         f"(t, {limb.N32}, B)")
    t = state.shape[0]
    if t not in PARTIAL_ROUNDS:
        raise ValueError(f"state: no Poseidon parameters for width {t}")
    return t


def permute_plain(lf: LimbField, state: torch.Tensor, spread: bool = False,
                  sparse: bool = False) -> torch.Tensor:
    """K5's plain version: (t, 8, B) int32 -> (t, 8, B) int32, any device;
    `spread` repeats the arithmetic of K5's SPREAD launch, `sparse` that
    of its THREAD launch (the same values, reached other ways)."""
    _check_state(state)
    s = limb.split32(state.transpose(0, 1))
    s = _permute16_sparse(lf, s) if sparse else _permute16(lf, s, spread)
    return limb.join16(s).transpose(0, 1).contiguous()


def permute(lf: LimbField, state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation of each state of a (t, 8, B) int32 batch: K5 on
    a CUDA tensor, `permute_plain` on a CPU tensor."""
    _check_state(state)
    if state.device.type == "cpu":
        return permute_plain(lf, state)
    return poseidon_kernel.launch(lf, state)


def hash_elems(lf: LimbField, elems: torch.Tensor, t: int = 5
               ) -> torch.Tensor:
    """One-shot batched hash of (t-1, 8, B) Montgomery elements -> (8, B).

    Fixed-length absorb of t-1 elements with a SAFE-style domain tag in
    the capacity lane, one permutation, squeeze lane 1 (the host
    HostSponge with the pattern [absorb t-1, squeeze 1])."""
    if elems.shape[0] != t - 1:
        raise ValueError(f"elems: {elems.shape[0]} rows, expected {t - 1}")
    io = IOPattern([("absorb", t - 1), ("squeeze", 1)])
    tag = tag_elem(lf, io, elems.device)
    state = torch.cat([tag.expand(1, limb.N32, elems.shape[2]), elems])
    return permute(lf, state.contiguous())[1]


_TAGS: Dict[Tuple[LimbField, int, str], torch.Tensor] = {}


def tag_elem(lf: LimbField, io: IOPattern, device="cpu") -> torch.Tensor:
    """The pattern's tag as a Montgomery (1, 8, 1) int32 field row on
    `device` (cached)."""
    key = (lf, io.tag_int(), str(device))
    if key not in _TAGS:
        _TAGS[key] = lf.encode32([io.tag_int() % lf.p_int],
                                 device).reshape(1, limb.N32, 1)
    return _TAGS[key]
