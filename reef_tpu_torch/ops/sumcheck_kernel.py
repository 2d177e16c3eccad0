"""K6: the nlookup sumcheck round's three kernels (csrc/sumcheck.cu) and
the table encode (csrc/sc_encode.cu).

Not the port of a TPU kernel: the JAX package computes these steps in XLA
(ops/sumcheck_device.py `_one_round_kernel` and `_build_eq_kernel`).  They
are CUDA here because the port's plain limb arithmetic costs some 200
torch launches per Montgomery product.

Tables are (8, n) int32 field rows (ops.limb's kernel layout, Montgomery).
A round reads a table as its two halves, (8, half) views that may share a
row stride larger than `half` (the halves of one (8, 2 half) table, or the
two planes of a (2, 8, half) split-halved table).  Each wrapper launches
its kernel on CUDA tensors and runs its plain version, in the same module,
on CPU tensors:

  coeffs  -> g = (xsq, x, con) as (3, 8, 1), and with a (t, 8, 1) sponge
             state the state with con, x, xsq added into lanes 1, 2, 3,
             in one launch (`coeff_plan`);
  fold    -> both tables folded by the challenge r, an (8, 1) row that
             stays on the device;
  eq_step -> one doubling step of the eq table's running-claim term;
  encode  -> an (n,) int64 tensor of a table's values in [0, 2^63) as
             the (8, n_pad) Montgomery table, zero past n.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import cudabuild
from . import limb
from .limb import LimbField

THREADS = 256          # csrc/sumcheck.cu SC_THREADS
MAX_BLOCKS = 2 * 132   # coefficient pass: two blocks per H100 SM


def _check_rows(name: str, *ts: torch.Tensor) -> None:
    """(8, n) int32 views with unit column stride and one row stride."""
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
        if t.dim() != 2 or t.shape[0] != limb.N32 or \
                (t.shape[1] > 1 and t.stride(1) != 1):
            raise ValueError(f"{name}: shape {tuple(t.shape)} / stride "
                             f"{t.stride()}, expected an (8, n) view with "
                             "unit column stride")
        if t.shape != ts[0].shape or t.stride(0) != ts[0].stride(0) \
                or t.device != ts[0].device:
            raise ValueError(f"{name}: views differ in shape, stride or "
                             "device")


# ---- round coefficients (+ sponge absorb) -----------------------------------

def _tree_sum(lf: LimbField, a: torch.Tensor) -> torch.Tensor:
    """(16, n) -> (16, 1) modular sum by halving adds (n a power of two)."""
    while a.shape[1] > 1:
        h = a.shape[1] // 2
        a = limb.add(lf, a[:, :h], a[:, h:2 * h])
    return a


def _absorb_plain(lf: LimbField, g: torch.Tensor,
                 state: torch.Tensor) -> torch.Tensor:
    """`state` (t, 8, 1) with lanes 1, 2, 3 plus con, x, xsq of g."""
    out = state.clone()
    for lane, c in ((1, 2), (2, 1), (3, 0)):
        out[lane] = limb.join16(limb.add(lf, limb.split32(state[lane]),
                                         limb.split32(g[c])))
    return out


def coeffs_plain(lf: LimbField, t0, t1, e0, e1,
                 state: Optional[torch.Tensor] = None):
    """The coefficient kernel's plain version, any device: the reference's
    four products a pair (the kernel computes x from three)."""
    a0, a1, b0, b1 = (limb.split32(x) for x in (t0, t1, e0, e1))
    ts = limb.sub(lf, a1, a0)
    es = limb.sub(lf, b1, b0)
    xsq = _tree_sum(lf, limb.mul(lf, ts, es))
    x = _tree_sum(lf, limb.add(lf, limb.mul(lf, es, a0),
                               limb.mul(lf, ts, b0)))
    con = _tree_sum(lf, limb.mul(lf, a0, b0))
    g = torch.stack([limb.join16(v) for v in (xsq, x, con)])
    return g, (None if state is None else _absorb_plain(lf, g, state))


def coeff_plan(half: int) -> Tuple[int, int]:
    """(grid, threads) of the coefficient launch over `half` pairs: blocks
    of THREADS while there are pairs for them, at most MAX_BLOCKS (the
    rest by grid stride); below THREADS pairs one block of as many whole
    warps as the pairs need."""
    threads = min(THREADS, -(-half // 32) * 32)
    return min(-(-half // threads), MAX_BLOCKS), threads


_TICKETS = {}


def _ticket(device: torch.device) -> torch.Tensor:
    """The coefficient launch's block counter on `device` (one int32, 0
    between launches: the last block resets it)."""
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros(1, dtype=torch.int32,
                                           device=device)
    return t


def coeffs(lf: LimbField, t0: torch.Tensor, t1: torch.Tensor,
           e0: torch.Tensor, e1: torch.Tensor,
           state: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The round's coefficients g = (xsq, x, con), (3, 8, 1) int32, over
    the pairs of the halves t0, t1 and e0, e1 (half a power of two); with
    a (t, 8, 1) sponge state also the absorbed state (a new tensor)."""
    _check_rows("t halves", t0, t1)
    _check_rows("eq halves", e0, e1)
    half = t0.shape[1]
    if e0.shape[1] != half or e0.device != t0.device or half & (half - 1):
        raise ValueError("coeffs: halves differ in length or device, or "
                         "their length is not a power of two")
    if state is not None and (
            state.dtype != torch.int32 or state.dim() != 3
            or state.shape[0] < 4 or state.shape[1:] != (limb.N32, 1)
            or not state.is_contiguous() or state.device != t0.device):
        raise ValueError(f"coeffs: state {tuple(state.shape)} is not a "
                         "contiguous (t >= 4, 8, 1) int32 tensor beside "
                         "the tables")
    if not cudabuild.on_card("coeffs", t0):
        return coeffs_plain(lf, t0, t1, e0, e1, state)
    g = torch.empty((3, limb.N32, 1), dtype=torch.int32, device=t0.device)
    st_out = None if state is None else torch.empty_like(state)
    st_args = ((0, 0, 0) if state is None
               else (state.data_ptr(), st_out.data_ptr(), state.shape[0]))
    grid, threads = coeff_plan(half)
    partial = ticket = None
    if grid > 1:
        partial = torch.empty((3, limb.N32, grid), dtype=torch.int32,
                              device=t0.device)
        ticket = _ticket(t0.device)
    cudabuild.launch(
        "sumcheck", "reef_sc_coeffs", t0.device, t0.data_ptr(),
        t1.data_ptr(), e0.data_ptr(), e1.data_ptr(), t0.stride(0),
        e0.stride(0), half, grid, threads,
        *((0, 0) if partial is None else (partial.data_ptr(),
                                          ticket.data_ptr())),
        g.data_ptr(), *st_args, lf.field_id)
    cudabuild.count("sumcheck_coeffs")
    return g, st_out


# ---- fold -------------------------------------------------------------------

def fold_plain(lf: LimbField, t0, t1, e0, e1, r):
    """The fold kernel's plain version, any device."""
    rr = limb.split32(r)
    out = []
    for x0, x1 in ((t0, t1), (e0, e1)):
        a0 = limb.split32(x0)
        d = limb.sub(lf, limb.split32(x1), a0)
        out.append(limb.join16(limb.add(lf, a0, limb.mul(lf, rr, d))))
    return out[0], out[1]


def fold(lf: LimbField, t0: torch.Tensor, t1: torch.Tensor,
         e0: torch.Tensor, e1: torch.Tensor, r: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t0 + r (t1 - t0), e0 + r (e1 - e0)), two new (8, half) tables; r is
    an (8, 1) int32 row on the tables' device."""
    _check_rows("t halves", t0, t1)
    _check_rows("eq halves", e0, e1)
    _check_rows("r", r)
    half = t0.shape[1]
    if e0.shape[1] != half or r.shape[1] != 1 or \
            len({t0.device, e0.device, r.device}) != 1:
        raise ValueError("fold: halves differ in length, r is not one "
                         "row, or the devices differ")
    if not cudabuild.on_card("fold", t0):
        return fold_plain(lf, t0, t1, e0, e1, r)
    t_out = torch.empty((limb.N32, half), dtype=torch.int32,
                        device=t0.device)
    e_out = torch.empty_like(t_out)
    cudabuild.launch(
        "sumcheck", "reef_sc_fold", t0.device, t0.data_ptr(), t1.data_ptr(),
        e0.data_ptr(), e1.data_ptr(), t0.stride(0), e0.stride(0),
        r.data_ptr(), r.stride(0), t_out.data_ptr(), e_out.data_ptr(), half,
        lf.field_id)
    cudabuild.count("sumcheck_fold")
    return t_out, e_out


# ---- eq doubling step -------------------------------------------------------

def eq_step_plain(lf: LimbField, term, q, eq=None):
    """The eq step kernel's plain version, any device."""
    x, qq = limb.split32(term), limb.split32(q)
    one = lf.const("one", qq)
    lo = limb.mul(lf, x, limb.sub(lf, one.expand_as(qq), qq))
    hi = limb.mul(lf, x, qq)
    out = torch.stack([lo, hi], dim=2).reshape(limb.N, -1)
    if eq is not None:
        out = limb.add(lf, out, limb.split32(eq))
    return limb.join16(out)


def eq_step(lf: LimbField, term: torch.Tensor, q: torch.Tensor,
            eq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(8, m) term -> (8, 2m): [2k] = term[k] (1 - q), [2k+1] = term[k] q,
    plus `eq` (8, 2m) where given; q is an (8, 1) row (any row stride)."""
    _check_rows("term", term)
    _check_rows("q", q)
    m = term.shape[1]
    if q.shape[1] != 1 or q.device != term.device:
        raise ValueError("eq_step: q is not one row beside the term")
    if eq is not None:
        _check_rows("eq", eq)
        if eq.shape[1] != 2 * m or eq.device != term.device:
            raise ValueError("eq_step: eq is not (8, 2m) beside the term")
        if not eq.is_contiguous():
            raise ValueError("eq_step: eq is not contiguous")
    if not term.is_contiguous():
        raise ValueError("eq_step: term is not contiguous")
    if not cudabuild.on_card("eq_step", term):
        return eq_step_plain(lf, term, q, eq)
    out = torch.empty((limb.N32, 2 * m), dtype=torch.int32,
                      device=term.device)
    cudabuild.launch(
        "sumcheck", "reef_sc_eq_step", term.device, term.data_ptr(), m,
        q.data_ptr(), q.stride(0), 0 if eq is None else eq.data_ptr(),
        out.data_ptr(), lf.field_id)
    cudabuild.count("sumcheck_eq")
    return out


# ---- table encode -----------------------------------------------------------

def table_words(lf: LimbField, xs, n_pad: int) -> np.ndarray:
    """The host encoder's table: the values xs Montgomery-encoded
    (limb.mont_words) and padded with zeros to n_pad entries, as (8,
    n_pad) int32 words."""
    words = np.zeros((n_pad, limb.N32), np.uint32)
    words[:len(xs)] = limb.mont_words(lf, xs)
    return words.view(np.int32).T


def encode_plain(lf: LimbField, vals: torch.Tensor,
                 n_pad: int) -> torch.Tensor:
    """The encode kernel's plain version, any device: the host encoder's
    table of the values, each read as 64 unsigned bits as the kernel
    reads it."""
    xs = vals.cpu().numpy().view(np.uint64).tolist()
    return torch.from_numpy(np.ascontiguousarray(
        table_words(lf, xs, n_pad))).to(vals.device)


def encode(lf: LimbField, vals: torch.Tensor, n_pad: int) -> torch.Tensor:
    """A new (8, n_pad) int32 table: column k the Montgomery form of
    vals[k] for k < n, 0 after; `vals` a contiguous (n,) int64 tensor,
    each value read as 64 unsigned bits (v + 2^64 for a negative v: the
    caller keeps to [0, 2^63), limb.small_values)."""
    if vals.dtype != torch.int64 or vals.dim() != 1 or \
            not vals.is_contiguous():
        raise ValueError(f"encode: values {vals.dtype} {tuple(vals.shape)} "
                         "are not a contiguous (n,) int64 tensor")
    if not 0 < n_pad or vals.shape[0] > n_pad:
        raise ValueError(f"encode: {vals.shape[0]} values do not fit "
                         f"{n_pad} entries")
    if not cudabuild.on_card("encode", vals):
        return encode_plain(lf, vals, n_pad)
    out = torch.empty((limb.N32, n_pad), dtype=torch.int32,
                      device=vals.device)
    cudabuild.launch("sc_encode", "reef_sc_encode", vals.device,
                     vals.data_ptr(), vals.shape[0], n_pad, out.data_ptr(),
                     lf.field_id)
    cudabuild.count("sumcheck_encode")
    return out
