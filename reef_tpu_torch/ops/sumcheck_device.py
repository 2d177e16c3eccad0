"""The nlookup sumcheck prover on a torch device: eq build, rounds, folds.

The port of the JAX package's ops/sumcheck_device.py, the per-batch hot
loop of the prover (the reference's r1cs_helper.rs:441-506 runs it in rug
bignum on one core).  The whole round loop runs on the device:

  - eq table: the claim powers scattered onto the lookup rows, plus the
    running-claim term built by ell doubling steps (K6 `eq_step`);
  - each round: the three degree-2 coefficients summed over the table
    pairs and absorbed into the t = 9 Poseidon sponge state (K6
    `coeffs`), one permutation (K5), the challenge r = lane 1, both
    tables folded by r (K6 `fold`, which reads r from device memory);
  - the folded T table's final entry is the next running claim T~(sc_rs).

Nothing is copied to the host between rounds: the challenges, the
coefficients, the final claim and the sponge state come back in one copy
at the end.  The initial absorb (combined qs, lookup values, running
claim) runs on the host sponge, whose state then moves to the device.  On
CPU tensors every step runs its kernel's plain version.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import limb, poseidon_device
from . import sumcheck_kernel as K
from .limb import LimbField
from .poseidon import HostSponge


class DeviceTableCache:
    """Montgomery-encoded device copy of a (constant) lookup table, padded
    with zeros to 2^ell entries, as an (8, 2^ell) int32 table."""

    def __init__(self, lf: LimbField, table: List[int], device=None):
        from ..utils.device import resolve
        self.lf = lf
        self.device = resolve(device)
        self.ell = max(1, (len(table) - 1).bit_length())
        n = 1 << self.ell
        words = np.zeros((n, limb.N32), np.uint32)
        words[:len(table)] = limb.mont_words(lf, table)
        self.t_dev = torch.from_numpy(
            np.ascontiguousarray(words.view(np.int32).T)).to(self.device)


def build_eq(lf: LimbField, ell: int, qs_idx: torch.Tensor,
             rs_pow: torch.Tensor, run_pow: torch.Tensor,
             prev_q: torch.Tensor) -> torch.Tensor:
    """The eq table (8, 2^ell): the pre-combined claim sums rs_pow (8, m)
    set at the distinct rows qs_idx (m,), plus the running-claim term
    r^{m+1} * prod_j ~eq(bit_j(i), prev_q[j]) built by ell doubling steps
    from run_pow (8, 1) with prev_q (8, ell), MSB first."""
    eq = torch.zeros((limb.N32, 1 << ell), dtype=torch.int32,
                     device=rs_pow.device)
    eq[:, qs_idx] = rs_pow
    term = run_pow
    for j in range(ell):
        term = K.eq_step(lf, term, prev_q[:, j:j + 1],
                         eq if j == ell - 1 else None)
    return term


def sumcheck_rounds(lf: LimbField, t_tab: torch.Tensor, eq_tab: torch.Tensor,
                    state: torch.Tensor, ell: int):
    """All ell rounds from the sponge state (t, 8, 1) at pos 1, squeezing.
    Returns device tensors: challenges (ell, 8, 1), coefficients
    (ell, 3, 8, 1) as (xsq, x, con), the final T entry (8, 1) and the
    sponge state after the last squeeze."""
    rs, gs = [], []
    for _ in range(ell):
        half = t_tab.shape[1] // 2
        t0, t1 = t_tab[:, :half], t_tab[:, half:]
        e0, e1 = eq_tab[:, :half], eq_tab[:, half:]
        # absorb [con, x, xsq] at lanes 1..3 (squeeze -> absorb resets the
        # position without a permutation), permute, squeeze lane 1
        g, state = K.coeffs(lf, t0, t1, e0, e1, state)
        state = poseidon_device.permute(lf, state)
        r = state[1]
        t_tab, eq_tab = K.fold(lf, t0, t1, e0, e1, r)
        rs.append(r)
        gs.append(g)
    return torch.stack(rs), torch.stack(gs), t_tab, state


def device_sumcheck_rounds(lf: LimbField, cache: DeviceTableCache,
                           qs: List[int], rs: List[int], prev_q: List[int],
                           sponge: HostSponge
                           ) -> Tuple[List[int], List[Tuple[int, int, int]],
                                      int]:
    """Run all rounds on the cache's device, syncing the host sponge after.

    rs = [r^1..r^{m+1}] claim powers; returns (sc_rs, g_coeffs, next_v)."""
    ell, dev, p = cache.ell, cache.device, lf.p_int
    # the device sponge starts from the host sponge after the claim_r squeeze
    if not (sponge.squeezing and sponge.pos == 1):
        raise ValueError("device sumcheck: the host sponge must be "
                         "squeezing at position 1")
    t = len(sponge.state)
    state = lf.encode32(sponge.state, dev).reshape(limb.N32, t, 1) \
        .permute(1, 0, 2).contiguous()
    # pre-combine duplicate lookup rows on the host (mod p), so that the
    # scatter is a plain set; pad by repeating the last (row, value) pair,
    # a write that is idempotent, to keep one shape per circuit
    combined = {}
    for i, q in enumerate(qs):
        combined[q] = (combined.get(q, 0) + rs[i]) % p
    idxs = sorted(combined)
    vals = [combined[q] for q in idxs]
    idxs += [idxs[-1]] * (len(qs) - len(idxs))
    vals += [vals[-1]] * (len(qs) - len(vals))
    qs_idx = torch.tensor(idxs, dtype=torch.int64, device=dev)
    eq_tab = build_eq(lf, ell, qs_idx, lf.encode32(vals, dev),
                      lf.encode32([rs[len(qs)]], dev),
                      lf.encode32(prev_q, dev))

    rs_out, gs_out, final_t, state = sumcheck_rounds(
        lf, cache.t_dev, eq_tab, state, ell)
    # one copy back: challenges, coefficients, final claim, sponge state
    back = torch.cat([rs_out.permute(1, 0, 2).reshape(limb.N32, -1),
                      gs_out.permute(2, 0, 1, 3).reshape(limb.N32, -1),
                      final_t, state.permute(1, 0, 2).reshape(limb.N32, -1)],
                     dim=1)
    vals = lf.decode32(back)
    sc_rs = vals[:ell]
    gs = vals[ell:4 * ell]
    g_coeffs = [(gs[3 * i], gs[3 * i + 1], gs[3 * i + 2])
                for i in range(ell)]
    next_v = vals[4 * ell]
    sponge.state = vals[4 * ell + 1:]
    sponge.pos = 1
    sponge.squeezing = True
    return sc_rs, g_coeffs, next_v
