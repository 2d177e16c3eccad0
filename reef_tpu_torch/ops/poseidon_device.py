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
from typing import Dict, Tuple

import numpy as np
import torch

from . import limb, poseidon_kernel
from .limb import LimbField
from .poseidon import IOPattern
from .poseidon_constants import FULL_ROUNDS, PARTIAL_ROUNDS, poseidon_params


@functools.lru_cache(maxsize=None)
def _device_consts(lf: LimbField, t: int) -> Tuple[np.ndarray, np.ndarray]:
    """Round constants (n_rounds, t, 8) and MDS (t, t, 8), Montgomery, as
    uint32 words of 32-bit limbs (the kernels' constant tables)."""
    rc, mds = poseidon_params(lf.p_int, t)
    n_rounds = FULL_ROUNDS + PARTIAL_ROUNDS[t]
    rc_w = limb.mont_words(lf, rc).reshape(n_rounds, t, limb.N32)
    mds_w = limb.mont_words(lf, [m for row in mds for m in row])
    return rc_w, mds_w.reshape(t, t, limb.N32)


_PLAIN: Dict[Tuple[LimbField, int, str], Tuple[torch.Tensor, ...]] = {}


def _plain_consts(lf: LimbField, t: int, device: torch.device):
    """(rc (n_rounds, 16, t, 1), mds (16, t, t, 1)) int64 on `device`."""
    key = (lf, t, str(device))
    if key not in _PLAIN:
        rc_w, mds_w = _device_consts(lf, t)
        rc = torch.from_numpy(rc_w.view(np.int32).copy()).to(device)
        rc = limb.split32(rc.permute(2, 0, 1)).permute(1, 0, 2)[..., None]
        mds = torch.from_numpy(mds_w.view(np.int32).copy()).to(device)
        mds = limb.split32(mds.permute(2, 0, 1))[..., None]
        _PLAIN[key] = (rc.contiguous(), mds.contiguous())
    return _PLAIN[key]


def _mds_plain(lf: LimbField, s: torch.Tensor,
               mds: torch.Tensor) -> torch.Tensor:
    """out_i = sum_j mds[i][j] s_j on (16, t, B) int64: the t products of a
    row summed as 32 schoolbook columns (each below 2^40), then one REDC."""
    t = s.shape[1]
    cols = torch.zeros((2 * limb.N,) + tuple(s.shape[1:]), dtype=torch.int64,
                       device=s.device)
    for a in range(limb.N):
        cols[a:a + limb.N] += (mds * s[a][None, None]).sum(dim=2)
    out = limb.redc_cols(lf, cols)
    # a sum of t products of values below p is below t p^2, so the REDC
    # result is below (t p / 2^256 + 1) p < (t / 4 + 1.01) p: redc_cols'
    # two subtracts leave it below (t / 4 - 0.99) p
    for _ in range(t // 4 - 1):
        out = limb.cond_sub_p(lf, out)
    return out


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
        s = _mds_plain(lf, s, mds)
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


def permute_plain(lf: LimbField, state: torch.Tensor,
                  spread: bool = False) -> torch.Tensor:
    """K5's plain version: (t, 8, B) int32 -> (t, 8, B) int32, any device;
    `spread` repeats the arithmetic of K5's SPREAD launch (the same
    values, reached another way)."""
    _check_state(state)
    s = _permute16(lf, limb.split32(state.transpose(0, 1)), spread)
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
