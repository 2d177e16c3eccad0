"""The IPA prover's rounds on the card: `IpaDevice`, and `IpaMesh` over a
mesh's sharded basis.

A drop-in for ec/native_msm.py `IpaNative` (`cross`, `fold`, `final`,
`close`), which backend/ipa.py `ipa_prove` takes where backend/routes.py
sends the vector's length to the card or the mesh.  The round state lives
on the basis's device (a mesh's lead) as (8, n) int32 scalar-field tables
(ops.limb's device layout): w and R canonical, the fold coefficients
Montgomery (csrc/ipa.cu says why).  `IpaDevice`'s basis is the gens' resident
`device_G()`; `IpaMesh`'s is the basis the process mesh already holds,
`sharded_G(mesh)`, so a mesh never uploads the whole basis to one card.
The engine uploads w and R once and nothing else.  A round:

  1. `scalars`: both rows of expanded scalars over the original basis as
     the MSM's scalar bytes, side by side (n2, 64);
  2. `dots`: the two cross dots, one partial a block;
  3. ec/msm_v3.py `msm_windows` over the resident basis, the two rows as
     64 windows (K2's tree, then K1's reduces); on a mesh, each shard's
     slice of the scalar bytes is copied to its card, each shard runs
     `msm_windows` over its own points and the lead adds the shards'
     window sums with one K1 reduce (parallel/mesh.py
     `sharded_windows`);
  4. `combine`: each row's window sums by Horner, and the dots' partials
     summed, into one (3 * 8 * 2 + 16) int32 buffer, read back with one
     copy that waits on the engine's streams alone;
  5. `fold(x)`: w, R and the coefficients folded by the challenge.

Every round's MSMs run over the whole original basis, each row zero
where a point does not contribute (on a mesh, the shards past the
vector's length are skipped): a basis folded on the card to the current
length was 10% faster for the IPA alone at Pallas 2^16, too little to
show in a prove (PERF.md).  Each wrapper launches its kernel on a CUDA
tensor and runs its plain version (the same arithmetic in plain torch,
ops.limb and ec.msm) on a CPU tensor; every launch counts once under its
kernel's name (`ipa_scalars`, `ipa_dots`, `ipa_combine`, `ipa_fold`).
Each engine has its own CUDA stream on every card it uses, so the
compressed SNARK's two Spartan proofs can run their rounds at once.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch

from ..ops import limb
from ..ops.limb import LimbField
from ..parallel import mesh as PM
from ..utils import cudabuild
from ..utils.metrics import span
from .msm import CurveKernels, padd as _padd16
from .msm_v3 import N_WINDOWS, msm_windows
from .padd import limb_join, limb_split
from .pasta import Point

ROWS = 2                  # a round's two MSMs, L and R
DOT_THREADS = 256         # csrc/ipa.cu DOT_THREADS
DOT_MAX_GRID = 64
DOT_PAIRS = 4             # pairs a dot thread takes at least
COMBINE_ROWS = 4          # csrc/ipa.cu COMBINE_ROWS


def scalar_field(curve) -> LimbField:
    """The curve's scalar field (its group order), where w and R live."""
    return limb.FQ if curve.name == "pallas" else limb.FP


def _check_table(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if t.dim() != 2 or t.shape[0] != limb.N32 or not t.is_contiguous():
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected a "
                         f"contiguous ({limb.N32}, n)")


def _const(value: int, device) -> torch.Tensor:
    """One element (16, 1) int64 in the plain layout."""
    w = limb._ints_to_words([value], np.uint16).astype(np.int64)
    return torch.from_numpy(w.T.copy()).to(device)


def _tree_sum(f: LimbField, t: torch.Tensor) -> torch.Tensor:
    """(16, k, m) -> (16, k): the sum over the last axis by halving."""
    while t.shape[-1] > 1:
        if t.shape[-1] % 2:
            t = torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)
        h = t.shape[-1] // 2
        t = limb.add(f, t[..., :h], t[..., h:])
    return t[..., 0]


# ---------------------------------------------------------------------------
# the expanded scalars
# ---------------------------------------------------------------------------

def scalars_plain(sf: LimbField, w: torch.Tensor, coeff: torch.Tensor,
                  n: int, out: torch.Tensor) -> None:
    """The kernel's plain version: rows [0, n_orig) of `out`."""
    n_orig = coeff.shape[1]
    half = n // 2
    j = torch.arange(n_orig, device=w.device)
    pos = j & (n - 1)
    to_l = (pos >= half)[:, None]
    src = torch.where(pos >= half, pos - half, pos + half)
    s = limb.join16(limb.mul(sf, limb.split32(w[:, src]),
                             limb.split32(coeff))).t()        # (n_orig, 8)
    zero = torch.zeros_like(s)
    rows = torch.cat([torch.where(to_l, s, zero),
                      torch.where(to_l, zero, s)], dim=1).contiguous()
    out[:n_orig] = rows.view(torch.uint8)


def scalars(sf: LimbField, w: torch.Tensor, coeff: torch.Tensor, n: int,
            out: torch.Tensor) -> None:
    """Both rows of round n's expanded scalars into `out` (n2, 64) uint8:
    row L (bytes 0..31) w[pos - n/2] coeff[j] where pos = j mod n >= n/2,
    row R (bytes 32..63) w[n/2 + pos] coeff[j] elsewhere, canonical
    little-endian; rows from n_orig on are left as they are (zero)."""
    _check_table("w", w)
    _check_table("coeff", coeff)
    n_orig = coeff.shape[1]
    if (out.dtype != torch.uint8 or out.dim() != 2
            or out.shape[1] != 32 * ROWS or out.shape[0] < n_orig
            or not out.is_contiguous()):
        raise ValueError(f"scalars: out {tuple(out.shape)} {out.dtype}")
    if n < 2 or n & (n - 1) or n > n_orig or w.shape[1] != n_orig:
        raise ValueError(f"scalars: n {n} for tables of {n_orig}")
    if not cudabuild.on_card("ipa_scalars", w):
        return scalars_plain(sf, w, coeff, n, out)
    cudabuild.launch("ipa", "reef_ipa_scalars", w.device, w.data_ptr(),
                     coeff.data_ptr(), out.data_ptr(), n_orig, n,
                     sf.field_id)
    cudabuild.count("ipa_scalars")


# ---------------------------------------------------------------------------
# the cross dots
# ---------------------------------------------------------------------------

def dot_grid(half: int) -> int:
    """Blocks of the dots' launch: DOT_PAIRS pairs a thread at least."""
    per_block = DOT_PAIRS * DOT_THREADS
    return max(1, min(DOT_MAX_GRID, -(-half // per_block)))


def dots_plain(sf: LimbField, w: torch.Tensor, R: torch.Tensor,
               half: int) -> torch.Tensor:
    """The kernel's plain version, as one partial: (2, 8, 1)."""
    a = limb.mul(sf, limb.split32(w[:, :half]),
                 limb.split32(R[:, half:2 * half]))
    b = limb.mul(sf, limb.split32(w[:, half:2 * half]),
                 limb.split32(R[:, :half]))
    s = _tree_sum(sf, torch.stack([a, b], dim=1))             # (16, 2)
    return limb.join16(s).t()[:, :, None].contiguous()


def dots(sf: LimbField, w: torch.Tensor, R: torch.Tensor,
         half: int) -> torch.Tensor:
    """(2, 8, blocks) int32 partials of sum w[i] R[half + i] and sum
    w[half + i] R[i] over i < half, each product a Montgomery product of
    canonical values: the sums are the dots times R^-1 mod p."""
    _check_table("w", w)
    _check_table("R", R)
    if w.shape != R.shape or half < 1 or 2 * half > w.shape[1]:
        raise ValueError(f"dots: half {half} for {tuple(w.shape)}, "
                         f"{tuple(R.shape)}")
    if not cudabuild.on_card("ipa_dots", w):
        return dots_plain(sf, w, R, half)
    grid = dot_grid(half)
    out = torch.empty((2, limb.N32, grid), dtype=torch.int32,
                      device=w.device)
    cudabuild.launch("ipa", "reef_ipa_dots", w.device, w.data_ptr(),
                     R.data_ptr(), out.data_ptr(), w.shape[1], half, grid,
                     sf.field_id)
    cudabuild.count("ipa_dots")
    return out


# ---------------------------------------------------------------------------
# the window combine
# ---------------------------------------------------------------------------

def combine_plain(ck: CurveKernels, sf: LimbField, accs: torch.Tensor,
                  rows: int, partial: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version."""
    A = limb_split(accs)                                  # (3, 16, 32 rows)
    a = ck.ident16(accs.device)[:, :, None].expand(3, limb.N, rows)
    for w in reversed(range(N_WINDOWS)):
        for _ in range(8):
            a = _padd16(ck, a, a)
        a = _padd16(ck, a, A[..., w::N_WINDOWS])
    d = limb.join16(_tree_sum(sf, limb.split32(partial.transpose(0, 1))))
    return torch.cat([limb_join(a).reshape(-1), d.t().reshape(-1)])


def combine(ck: CurveKernels, sf: LimbField, accs: torch.Tensor, rows: int,
            partial: torch.Tensor) -> torch.Tensor:
    """(3 * 8 * rows + 16,) int32: the (3, 8, rows) projective sums
    sum_w 2^(8w) accs[r * 32 + w] of each row r, then the (2, 8) sums of
    the dots' partials."""
    if (accs.dtype != torch.int32 or tuple(accs.shape) !=
            (3, limb.N32, N_WINDOWS * rows) or not accs.is_contiguous()):
        raise ValueError(f"combine: window sums {tuple(accs.shape)}")
    if (partial.dim() != 3 or partial.shape[:2] != (2, limb.N32)
            or not partial.is_contiguous()):
        raise ValueError(f"combine: partials {tuple(partial.shape)}")
    if not 1 <= rows <= COMBINE_ROWS:
        raise ValueError(f"combine: {rows} rows")
    if not cudabuild.on_card("ipa_combine", accs):
        return combine_plain(ck, sf, accs, rows, partial)
    out = torch.empty(3 * limb.N32 * rows + 2 * limb.N32, dtype=torch.int32,
                      device=accs.device)
    cudabuild.launch("ipa", "reef_ipa_combine", accs.device, accs.data_ptr(),
                     rows, partial.data_ptr(), partial.shape[2],
                     out.data_ptr(), ck.lf.field_id)
    cudabuild.count("ipa_combine")
    return out


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------

def fold_plain(sf: LimbField, w: torch.Tensor, R: torch.Tensor,
               coeff: torch.Tensor, n: int, x_m: int, xi_m: int) -> None:
    """The kernel's plain version, in place."""
    half = n // 2
    X, XI = _const(x_m, w.device), _const(xi_m, w.device)
    mul = lambda a, b: limb.mul(sf, a, b)         # noqa: E731
    lo, hi = limb.split32(w[:, :half]), limb.split32(w[:, half:n])
    w[:, :half] = limb.join16(limb.add(sf, mul(X, lo), mul(XI, hi)))
    lo, hi = limb.split32(R[:, :half]), limb.split32(R[:, half:n])
    R[:, :half] = limb.join16(limb.add(sf, mul(XI, lo), mul(X, hi)))
    j = torch.arange(coeff.shape[1], device=w.device)
    by = torch.where(((j & (n - 1)) < half)[None], XI, X)
    coeff.copy_(limb.join16(mul(limb.split32(coeff), by)))


def fold(sf: LimbField, w: torch.Tensor, R: torch.Tensor,
         coeff: torch.Tensor, n: int, x_m: int, xi_m: int) -> None:
    """w <- x w_lo + x^-1 w_hi, R <- x^-1 R_lo + x R_hi (the first n/2
    entries), coeff[j] *= x^-1 where j mod n < n/2, else x; x_m and xi_m
    are x and x^-1 in Montgomery form.  In place."""
    for name, t in (("w", w), ("R", R), ("coeff", coeff)):
        _check_table(name, t)
    n_orig = coeff.shape[1]
    if w.shape != R.shape or w.shape[1] != n_orig or n < 2 \
            or n & (n - 1) or n > n_orig:
        raise ValueError(f"fold: n {n} for tables of {n_orig}")
    if not cudabuild.on_card("ipa_fold", w):
        return fold_plain(sf, w, R, coeff, n, x_m, xi_m)
    xs = limb._ints_to_words([x_m, xi_m], np.uint32).tobytes()
    cudabuild.launch("ipa", "reef_ipa_fold", w.device, w.data_ptr(),
                     R.data_ptr(), coeff.data_ptr(), n_orig, n, xs,
                     sf.field_id)
    cudabuild.count("ipa_fold")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _table(values, p: int, device) -> torch.Tensor:
    """(8, n) int32 canonical limbs of the values mod p, on `device`."""
    from ..ops.native_fieldvec import pack
    words = np.frombuffer(pack(values, p), np.uint32).reshape(-1, limb.N32)
    return torch.from_numpy(np.ascontiguousarray(words.T).view(np.int32)) \
        .to(device)


class IpaDevice:
    """Device IPA round engine over the resident basis of `gens`
    (backend/commitment.py PedersenGens): per round (cL, cR, mL, mR), as
    `IpaNative.cross`, then `fold(x)`; `final()` the folded scalar."""

    def __init__(self, gens, w: List[int], R: List[int]):
        self.basis = gens.device_G()
        self._start(gens.cv, self.basis.n, self.basis.device,
                    self.basis.n2, [self.basis.device], w, R)

    def _start(self, curve, n_basis: int, lead: torch.device,
               scb_rows: int, devices, w: List[int], R: List[int]) -> None:
        """The round state on `lead`, and a stream of the engine's own on
        each CUDA device of `devices`."""
        self.curve = curve
        self.ck = self.basis.ck
        self.sf = scalar_field(curve)
        n = len(w)
        if n < 2 or n & (n - 1) or len(R) != n or n > n_basis:
            raise ValueError(f"{type(self).__name__}: {n} scalars, {len(R)} "
                             f"R, a basis of {n_basis}")
        self.n = self.n_orig = n
        # the lead's stream last, so that the lead is current inside
        # `_on_stream`
        devs = [d for d in dict.fromkeys(devices) if d != lead] + [lead]
        self.streams: List[torch.cuda.Stream] = []
        for dev in devs:
            if dev.type == "cuda":
                s = torch.cuda.Stream(dev)
                # the basis and the constants came on the current stream
                s.wait_stream(torch.cuda.current_stream(dev))
                self.streams.append(s)
        p = self.sf.p_int
        one = limb._ints_to_words([self.sf.r_int], np.uint32)
        with self._on_stream():
            self.w = _table(w, p, lead)
            self.R = _table(R, p, lead)
            # coefficients of one over the n basis points
            self.coeff = torch.from_numpy(one.T.view(np.int32).copy()) \
                .to(lead).expand(limb.N32, n).contiguous()
            self.scb = torch.zeros((scb_rows, 32 * ROWS),
                                   dtype=torch.uint8, device=lead)

    def _on_stream(self):
        """The engine's streams current on their devices."""
        ctx = contextlib.ExitStack()
        for s in self.streams:
            ctx.enter_context(torch.cuda.stream(s))
        return ctx

    def _windows(self) -> torch.Tensor:
        """The round's (3, 8, 64) window sums, on the lead."""
        return msm_windows(self.ck, self.basis, self.scb)

    def cross(self) -> Tuple[int, int, Point, Point]:
        """This round's cL = <w_lo, R_hi>, cR = <w_hi, R_lo> and the MSMs
        <w_lo, G'_hi>, <w_hi, G'_lo> (affine, None for the identity)."""
        sf, ck, n = self.sf, self.ck, self.n
        with self._on_stream():
            scalars(sf, self.w, self.coeff, n, self.scb)
            part = dots(sf, self.w, self.R, n // 2)
            accs = self._windows()
            out = combine(ck, sf, accs, ROWS, part).cpu().numpy()
        npt = 3 * limb.N32 * ROWS
        mL, mR = ck.to_affine(out[:npt].reshape(3, limb.N32, ROWS)
                              .transpose(2, 0, 1))
        p, r = sf.p_int, sf.r_int
        cL, cR = (s * r % p for s in limb._words_to_ints(
            out[npt:].reshape(2, limb.N32), 32))
        return cL, cR, mL, mR

    def fold(self, x: int) -> None:
        sf = self.sf
        x %= sf.p_int
        with self._on_stream():
            fold(sf, self.w, self.R, self.coeff, self.n, sf.mont(x),
                 sf.mont(pow(x, -1, sf.p_int)))
        self.n //= 2

    def final(self) -> int:
        with self._on_stream():
            w0 = self.w[:, :1].cpu().numpy()
        return limb._words_to_ints(w0.T, 32)[0]

    def close(self) -> None:
        self.w = self.R = self.coeff = self.scb = None
        self.streams = []


class IpaMesh(IpaDevice):
    """`IpaDevice` over the basis `mesh` holds, `gens.sharded_G(mesh)`
    (parallel/mesh.py ShardedBasis; never `device_G()`): the round state,
    the scalars, the dots, the combine and the fold on the lead; each
    round, every shard that holds a point of the vector gets its slice of
    the scalar bytes (n_local rows) on its card and runs `msm_windows`
    over its own points, and the lead adds the shards' window sums
    (`sharded_windows`)."""

    def __init__(self, gens, w: List[int], R: List[int], mesh):
        self.basis = basis = gens.sharded_G(mesh)
        nl, lead = basis.n_local, mesh.lead
        shards = basis.shards[:max(1, -(-len(w) // nl))]
        self._start(gens.cv, basis.n, lead, nl * len(shards),
                    [b.device for b in shards], w, R)
        # each shard's scalar bytes: a buffer on its card whose first
        # rows each round copies from the lead (the rest stay zero: the
        # vector or the basis ends there)
        self.scbs: List[torch.Tensor] = []
        self.copies: List[Tuple[torch.Tensor, torch.Tensor]] = []
        with self._on_stream():
            for d, b in enumerate(shards):
                buf = torch.zeros((b.n2, 32 * ROWS), dtype=torch.uint8,
                                  device=b.device)
                m = min(nl, self.n_orig - d * nl)
                self.scbs.append(buf)
                self.copies.append((buf[:m], self.scb[d * nl:d * nl + m]))

    def _windows(self) -> torch.Tensor:
        with span("Mesh", "scalars"):
            for dst, src in self.copies:
                dst.copy_(src, non_blocking=True)
        return PM.sharded_windows(self.ck, self.basis, self.scbs)

    def close(self) -> None:
        super().close()
        self.scbs, self.copies = [], []
