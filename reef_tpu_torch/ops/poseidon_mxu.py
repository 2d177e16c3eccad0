"""Poseidon with the MDS mix as one integer matrix product per round.

Port of the JAX package's ops/poseidon_mxu.py.  The MDS product is linear
with a constant matrix, so for a batch it is one byte convolution:

    out8[(i, kb), b] = sum_{j, b2} A8[(i, kb), (j, b2)] * s8[(j, b2), b]

where s8 holds the 32 little-endian bytes of each state lane and A8 the
bytes of the Montgomery-form MDS entries, placed at byte antidiagonals
(kb = b1 + b2).  Pairs of byte columns then make 32 columns of 16 bits
for one shared REDC per output lane (`limb.redc_cols`; K4 under
`field_kernel.enable(redc=True)`).  The S-boxes are `limb.pow5`, three
`limb.mul` calls (K3 under the hook).

The reference's product is an XLA uint8 x uint8 -> int32 dot outside any
Pallas kernel.  Here it is a float64 `torch.matmul`: the card has no
integer matmul in torch, and float32 is not exact, since a t = 9 output
column sums up to 288 byte products (below 1.9e7 > 2^24).  Every partial
sum is an integer below 2^53, so the float64 product is exact in any
order.

The state is the plain layout, (16, t, B) int64; `permute` takes and
returns the kernels' (t, 8, B) int32 states, as ops/poseidon_device's
`permute` does, and gives the same results.  The rounds run as three
Python loops (full, partial, full), so a partial round raises only lane 0
to the fifth power.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from . import limb
from .limb import N, LimbField
from .poseidon_device import _check_state
from .poseidon_constants import FULL_ROUNDS, PARTIAL_ROUNDS, poseidon_params

BPE = 2 * N          # bytes per element (32)
OUT_COLS = 2 * BPE   # output byte columns (64)


@functools.lru_cache(maxsize=None)
def _mxu_consts(lf: LimbField, t: int) -> Tuple[np.ndarray, list]:
    """(A8 uint8 (t*32, t*64), contraction-major as in the reference;
    the round constants, Montgomery-form python ints, (rounds * t,))."""
    rc, mds = poseidon_params(lf.p_int, t)
    A = np.zeros((t * BPE, t * OUT_COLS), np.uint8)
    for i in range(t):
        for j in range(t):
            m = lf.mont(mds[i][j])
            mbytes = [(m >> (8 * b)) & 0xFF for b in range(BPE)]
            for b1 in range(BPE):
                if mbytes[b1] == 0:
                    continue
                for b2 in range(BPE):
                    A[j * BPE + b2, i * OUT_COLS + b1 + b2] = mbytes[b1]
    return A, list(rc)


_DEV: Dict[Tuple[LimbField, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _device_consts(lf: LimbField, t: int, device: torch.device):
    """(A8^T (t*64, t*32) float64, rc (rounds, 16, t, 1) int64) on
    `device`, cached."""
    key = (lf, t, str(device))
    if key not in _DEV:
        A, rc = _mxu_consts(lf, t)
        a8t = torch.from_numpy(A.T.astype(np.float64)).to(device)
        n_rounds = FULL_ROUNDS + PARTIAL_ROUNDS[t]
        rc16 = lf.encode(rc).reshape(N, n_rounds, t).permute(1, 0, 2)
        _DEV[key] = (a8t.contiguous(), rc16[..., None].contiguous()
                     .to(device))
    return _DEV[key]


def _mds_matmul(lf: LimbField, s: torch.Tensor,
                a8t: torch.Tensor) -> torch.Tensor:
    """(16, t, B) -> (16, t, B): the byte matmul, then one shared REDC."""
    t, B = s.shape[1], s.shape[2]
    s8 = torch.stack([s & 0xFF, (s >> 8) & 0xFF], dim=1)   # (16, 2, t, B)
    s8 = s8.permute(2, 0, 1, 3).reshape(t * BPE, B)        # rows (j, b2)
    out8 = torch.matmul(a8t, s8.to(torch.float64)).to(torch.int64)
    out8 = out8.reshape(t, BPE, 2, B)                      # rows (i, kb)
    cols = out8[:, :, 0] + (out8[:, :, 1] << 8)            # (t, 32, B)
    out = limb.redc_cols(lf, cols.transpose(0, 1))
    # the value is below t p^2, so the REDC leaves less than
    # (t p / 2^256 + 1) p < (t / 4 + 1.01) p, and redc_cols' two subtracts
    # less than (t / 4 - 0.99) p: canonical at t = 5, one more subtract
    # at t = 9 (the reference stops at two)
    for _ in range(t // 4 - 1):
        out = limb.cond_sub_p(lf, out)
    return out


def permute16(lf: LimbField, s: torch.Tensor) -> torch.Tensor:
    """The permutation on a (16, t, B) int64 plain-layout batch."""
    t = s.shape[1]
    a8t, rc = _device_consts(lf, t, s.device)
    half = FULL_ROUNDS // 2
    r_p = PARTIAL_ROUNDS[t]

    def full(s, r):
        s = limb.pow5(lf, limb.add(lf, s, rc[r]))
        return _mds_matmul(lf, s, a8t)

    def partial(s, r):
        s = limb.add(lf, s, rc[r])
        s = torch.cat([limb.pow5(lf, s[:, :1]), s[:, 1:]], dim=1)
        return _mds_matmul(lf, s, a8t)

    for r in range(half):
        s = full(s, r)
    for r in range(half, half + r_p):
        s = partial(s, r)
    for r in range(half + r_p, 2 * half + r_p):
        s = full(s, r)
    return s


def permute(lf: LimbField, state: torch.Tensor) -> torch.Tensor:
    """MXU-formulated Poseidon of each state of a (t, 8, B) int32 batch;
    equal to ops.poseidon_device.permute on any device."""
    _check_state(state)
    s = permute16(lf, limb.split32(state.transpose(0, 1)))
    return limb.join16(s).transpose(0, 1).contiguous()
