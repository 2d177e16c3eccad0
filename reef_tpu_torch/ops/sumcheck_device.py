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

A DeviceTableCache may split the table over the devices of a mesh
(parallel.mesh) by its low bits; its rounds (`sharded_rounds`) then run
the coefficients and the folds on each shard and the sponge on the lead,
recording the mesh's spans and counters (parallel/mesh.py): each round's
shard launches in `Mesh issue`, the coefficients' sum on the lead in
`Mesh gather` (no host wait: the rounds never sync), the eq table's
copies to the shards in `Mesh scalars`.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import limb, poseidon_device
from . import sumcheck_kernel as K
from .limb import LimbField
from ..utils.metrics import count, span
from .poseidon import HostSponge


def _table_words(lf: LimbField, table: List[int]) -> Tuple[int, np.ndarray]:
    """(ell, the table Montgomery-encoded and padded with zeros to 2^ell
    entries as (8, 2^ell) int32 words)."""
    ell = max(1, (len(table) - 1).bit_length())
    words = np.zeros((1 << ell, limb.N32), np.uint32)
    words[:len(table)] = limb.mont_words(lf, table)
    return ell, words.view(np.int32).T


class DeviceTableCache:
    """Montgomery-encoded device copy of a (constant) lookup table, padded
    with zeros to 2^ell entries, split over `devices` (default: whole on
    the engine device) by its low bits: shard d, an (8, 2^ell / m) table
    on devices[d], holds entries d, d + m, d + 2m, ...  m is a power of
    two, at most 2^ell.  An MSB-first round pairs entries j and j + half;
    while half >= m both lie on shard j mod m, at local k and k + half / m,
    so every shard runs the ordinary round on its own entries.  `device`
    is the lead, devices[0]."""

    def __init__(self, lf: LimbField, table: List[int], device=None,
                 devices=None):
        from ..utils.device import resolve
        self.lf = lf
        self.devices = [resolve(d) for d in (devices or [device])]
        self.device = self.devices[0]
        self.ell, words = _table_words(lf, table)
        m = len(self.devices)
        if m & (m - 1) or m > 1 << self.ell:
            raise ValueError(f"a table of 2^{self.ell} entries does not "
                             f"split over {m} devices (a power of two, at "
                             "most the table's size)")
        self.t_shards = self.split(torch.from_numpy(
            np.ascontiguousarray(words)))

    def split(self, tab: torch.Tensor) -> List[torch.Tensor]:
        """An (8, 2^ell) table split as the shards are, shard d on
        devices[d] (one device: the table itself, moved there)."""
        m = len(self.devices)
        return [tab[:, d::m].contiguous().to(dev)
                for d, dev in enumerate(self.devices)]


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


_SUM_PATTERNS = {}


def _sum_pattern(lf: LimbField, m: int, half: int,
                 device: torch.device) -> torch.Tensor:
    """The eq halves of `sum_coeffs`: (8, 2 half), e0 = 1 at columns
    [0, 2m), e1 = 1 at [0, 3m), 0 elsewhere (cached)."""
    key = (lf.field_id, m, half, device)
    e = _SUM_PATTERNS.get(key)
    if e is None:
        one = lf.encode32([1], device)
        e = torch.zeros((limb.N32, 2 * half), dtype=torch.int32,
                        device=device)
        e[:, :2 * m] = one
        e[:, half:half + 3 * m] = one
        e = _SUM_PATTERNS[key] = e
    return e


def sum_coeffs(lf: LimbField, parts: List[torch.Tensor], lead: torch.device,
               state: Optional[torch.Tensor] = None):
    """The sums mod p of m coefficient triples (3, 8, 1) (xsq, x, con), on
    `lead`, and with a sponge state there also the state with them
    absorbed: one coefficient launch (K6 `coeffs`) over pairs whose
    entries are the triples' values, 0 and 1.  Shard i's con is the pair
    t0 = t1 = con, e0 = e1 = 1 (it adds con to con and nothing else), its
    x the pair t0 = 0, t1 = x, e0 = e1 = 1 (x to x), its xsq the pair
    t0 = e0 = 0, t1 = xsq, e1 = 1 (xsq to xsq); the other pairs are 0."""
    m = len(parts)
    half = 1 << (3 * m - 1).bit_length()
    with span("Mesh", "gather"):
        count("Mesh", "gather_bytes",
              sum(g.numel() * g.element_size() for g in parts))
        G = torch.cat([g.to(lead) for g in parts], dim=2)   # (3, 8, m)
        t = torch.zeros((limb.N32, 2 * half), dtype=torch.int32,
                        device=lead)
        t[:, :m] = G[2]
        t[:, half:half + 3 * m] = G.flip(0).permute(1, 0, 2).reshape(
            limb.N32, 3 * m)                                # con, x, xsq
        e = _sum_pattern(lf, m, half, lead)
        return K.coeffs(lf, t[:, :half], t[:, half:], e[:, :half],
                        e[:, half:], state)


def sharded_rounds(lf: LimbField, t_shards: List[torch.Tensor],
                   e_shards: List[torch.Tensor], state: torch.Tensor,
                   ell: int):
    """`sumcheck_rounds` over tables split by their low bits over m shards
    (DeviceTableCache), the sponge state on the lead (the first shard's
    device); one shard is `sumcheck_rounds` itself.  While a shard holds
    two entries or more, each round's coefficients are each shard's (K6
    `coeffs`) summed and absorbed on the lead (`sum_coeffs`), the lead
    permutes (K5), and every shard folds by the challenge (K6 `fold`);
    then the lead gathers the m entries, entry d from shard d, and runs
    the last log2 m rounds alone.  No host sync: shards on different
    cards overlap, shards on one card share its current stream (K6's
    ticket is one a card)."""
    m = len(t_shards)
    if m == 1:
        return sumcheck_rounds(lf, t_shards[0], e_shards[0], state, ell)
    lead = state.device
    rs, gs = [], []
    while t_shards[0].shape[1] > 1:
        h = t_shards[0].shape[1] // 2
        count("Mesh", "shards", m)
        with span("Mesh", "issue"):
            parts = [K.coeffs(lf, t[:, :h], t[:, h:], e[:, :h],
                              e[:, h:])[0]
                     for t, e in zip(t_shards, e_shards)]
        g, state = sum_coeffs(lf, parts, lead, state)
        state = poseidon_device.permute(lf, state)
        r = state[1]
        with span("Mesh", "issue"):
            folded = [K.fold(lf, t[:, :h], t[:, h:], e[:, :h], e[:, h:],
                             r.to(t.device))
                      for t, e in zip(t_shards, e_shards)]
        t_shards = [tf for tf, _ in folded]
        e_shards = [ef for _, ef in folded]
        rs.append(r)
        gs.append(g)
    with span("Mesh", "gather"):
        count("Mesh", "gather_bytes",
              sum(t.numel() * t.element_size()
                  for t in t_shards + e_shards))
        t_tab = torch.cat([t.to(lead) for t in t_shards], dim=1)
        e_tab = torch.cat([e.to(lead) for e in e_shards], dim=1)
    rs2, gs2, final_t, state = sumcheck_rounds(lf, t_tab, e_tab, state,
                                               m.bit_length() - 1)
    return (torch.stack(rs + list(rs2)), torch.stack(gs + list(gs2)),
            final_t, state)


def device_sumcheck_rounds(lf: LimbField, cache: DeviceTableCache,
                           qs: List[int], rs: List[int], prev_q: List[int],
                           sponge: HostSponge
                           ) -> Tuple[List[int], List[Tuple[int, int, int]],
                                      int]:
    """Run all rounds on the cache's devices (`sharded_rounds`), syncing
    the host sponge after.

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

    # the eq table is built whole on the lead, then split as the table is
    # (on a mesh: the copies to the shards, `Mesh scalars`)
    with (span("Mesh", "scalars") if len(cache.devices) > 1
          else contextlib.nullcontext()):
        eq_shards = cache.split(eq_tab)
    rs_out, gs_out, final_t, state = sharded_rounds(
        lf, cache.t_shards, eq_shards, state, ell)
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
