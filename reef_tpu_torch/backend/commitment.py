"""Document commitments + consistency proofs (Hyrax/Pedersen layer).

Re-implements the role of the reference's commitment.rs + the nova fork's
hyrax_pc/pedersen/ipa_pc providers:

  - Pedersen vector/scalar commitments over Pallas (G1);
  - Hyrax polynomial commitment: the doc MLE's 2^l coefficients viewed as a
    2^lL x 2^lR matrix, one Pedersen vector commitment per row
    (commitment.rs:133-212); evaluation at q=(qL,qR) reduces homomorphically
    to an inner-product claim <w, R> = v with C_w = sum L_j C_j;
  - the inner-product claim is proven with a Schnorr-style sigma protocol
    (vector response, O(sqrt N) proof size).  The reference uses a log-round
    Bulletproofs IPA here (ipa_pc); the sigma argument is protocol-equivalent
    in soundness/zk and is the round-1 choice — the log-round IPA is a
    planned upgrade that changes only this module.
  - consistency proof: binds Nova's final doc running claim (q, v) to the
    committed polynomial, with projection index-prefixing and the hybrid
    split v = (1-q0)*t + q0*v' Schnorr equality proof
    (commitment.rs:214-444).

Fiat-Shamir for these host-side proofs runs over a SHA256 transcript
(replacing merlin); the doc-commitment hash (absorbed by the step circuit's
FS) is a Poseidon-over-Fp hash of the compressed row commitments, reduced
into Fq (replacing nova's PoseidonRO, commitment.rs:190-198).
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..ec.pasta import PALLAS, Curve, Point
from ..ops import field as F
from ..ops.poseidon import HostSponge, IOPattern
from .costs import logmn, next_power_of_two
from .sumcheck import verifier_mle_eval
from .step_circuit import StepCircuit, hide_pattern


class Transcript:
    """SHA256-based Fiat-Shamir transcript (host proofs only)."""

    def __init__(self, label: bytes):
        self.h = hashlib.sha256(b"reef_tpu/" + label)

    def append(self, label: bytes, data):
        self.h.update(len(label).to_bytes(2, "big") + label)
        if isinstance(data, int):
            self.h.update(data.to_bytes(32, "big"))
        elif isinstance(data, (list, tuple)):
            for d in data:
                self.append(b"", d)
        else:
            self.h.update(data)

    def append_point(self, label: bytes, cv: Curve, pt: Point):
        x, flag = cv.compress(pt)
        self.append(label, [x, flag])

    def challenge(self, label: bytes, order: int) -> int:
        self.h.update(b"challenge/" + label)
        out = int.from_bytes(self.h.digest(), "big") % order
        self.h.update(b"next")
        return out


# ---------------------------------------------------------------------------
# Pedersen
# ---------------------------------------------------------------------------

_GENS_MEM: dict = {}


def _validate_points(cv: Curve, pts: list) -> bool:
    """Range + on-curve check for a point list (native bulk path when
    available — the per-point python check was ~0.5s/process on the
    cached generator sets)."""
    try:
        from ..ec.native_msm import _load, _pack_points
        import ctypes
        lib = _load()
        if lib is not None:
            from ..ec.pasta import PALLAS
            fn = lib.pasta_on_curve
            fn.restype = ctypes.c_int64
            buf = bytes(_pack_points(pts))
            bad = fn(ctypes.c_int(0 if cv is PALLAS else 1),
                     ctypes.c_int64(len(pts)), buf)
            return bad == -1
    except Exception:
        pass
    return all(x < cv.p and y < cv.p and cv.on_curve((x, y))
               for (x, y) in pts)


def _validate_packed(cv: Curve, buf: bytes, n: int) -> bool:
    """Range + on-curve check of a native-packed (65 B/point LE) buffer;
    bulk C path when available, python decode fallback."""
    try:
        from ..ec.native_msm import _load
        import ctypes
        lib = _load()
        if lib is not None:
            from ..ec.pasta import PALLAS as _PL
            fn = lib.pasta_on_curve
            fn.restype = ctypes.c_int64
            bad = fn(ctypes.c_int(0 if cv is _PL else 1),
                     ctypes.c_int64(n), buf)
            return bad == -1
    except Exception:
        pass
    from ..ec.native_msm import _unpack_points
    return all(pt is not None and pt[0] < cv.p and pt[1] < cv.p
               and cv.on_curve(pt) for pt in _unpack_points(buf, n))


def _pt_at(buf: bytes, i: int) -> Point:
    return (int.from_bytes(buf[65 * i:65 * i + 32], "little"),
            int.from_bytes(buf[65 * i + 32:65 * i + 64], "little"))


def _cached_gens_packed(cv: Curve, label: bytes, n: int) -> bytes:
    """Disk-cached deterministic generator derivation (try-and-increment
    hash-to-curve costs ~2ms/point; suites re-derive thousands per
    process otherwise), returned in the native MSM's packed layout
    (65 B/point little-endian) so the hot paths never materialize python
    int tuples or re-pack (that cost ~0.6 s/process on the 2^16 basis).

    Derivation is per-index, so gens(label, m) is a PREFIX of
    gens(label, n) for m < n: the cache is keyed by label only and holds
    the longest set derived so far — a smaller request slices it, a
    larger one derives and appends just the missing tail.  An in-memory
    layer sits on top (committers for every proof structure share one
    basis per curve; see VectorCommitter).

    The file holds the PLAIN packed encoding (no pickle — a pickle cache
    was a code-execution surface) plus a whole-file sha256.  On load the
    buffer is bulk-checked on-curve and a fixed subset is re-derived from
    the label and compared; any mismatch falls back to the full
    deterministic re-derivation.  (A local attacker who can write
    the cache directory can precompute a consistent file for TAMPERED generator sets
    only by breaking hash-to-curve's preimage structure — the spot
    re-derivation pins the cached set to the real derivation at the
    checked indices, and full paranoia mode is simply deleting the
    cache.)"""
    import os

    mkey = (cv.name, label)
    mem = _GENS_MEM.get(mkey)
    if mem is not None and len(mem) >= 65 * n:
        return mem[:65 * n]

    from ..utils.nativebuild import build_dir
    cache_dir = build_dir("cache")
    key = hashlib.sha256(cv.name.encode() + b"/" + label
                         ).hexdigest()[:24]
    path2 = os.path.join(cache_dir, f"gens2_{key}.bin")
    path1 = os.path.join(cache_dir, f"gens_{key}.bin")

    def _spot_ok(buf: bytes, cnt: int) -> bool:
        for i in sorted({0, cnt - 1, cnt // 2, cnt // 3}):
            expect = cv.hash_to_curve(label + b"/" + i.to_bytes(8, "big"))
            if _pt_at(buf, i) != expect:
                return False
        return True

    packed = b""
    dirty = False                          # loaded-from-v1 / extended
    try:                                   # v2: packed layout
        with open(path2, "rb") as fh:
            raw = fh.read()
        body, chk = raw[:-32], raw[-32:]
        cnt = len(body) // 65
        if (hashlib.sha256(body).digest() == chk and len(body) == 65 * cnt
                and cnt and _validate_packed(cv, body, cnt)
                and _spot_ok(body, cnt)):
            packed = body
    except Exception:
        packed = b""
    if not packed:
        try:                               # v1 migration: 64 B/point BE
            with open(path1, "rb") as fh:
                raw = fh.read()
            body, chk = raw[:-32], raw[-32:]
            cnt = len(body) // 64
            if (hashlib.sha256(body).digest() == chk
                    and len(body) == 64 * cnt and cnt):
                cand = bytearray(65 * cnt)
                for i in range(cnt):
                    x = int.from_bytes(body[64 * i:64 * i + 32], "big")
                    y = int.from_bytes(body[64 * i + 32:64 * i + 64], "big")
                    cand[65 * i:65 * i + 32] = x.to_bytes(32, "little")
                    cand[65 * i + 32:65 * i + 64] = y.to_bytes(32, "little")
                cand = bytes(cand)
                if _validate_packed(cv, cand, cnt) and _spot_ok(cand, cnt):
                    packed = cand
                    dirty = True
        except Exception:
            packed = b""

    if len(packed) < 65 * n:
        have = len(packed) // 65
        from ..ec.native_msm import derive_gens_packed
        tail = derive_gens_packed(cv, label, have, n - have)
        if tail is not None:
            # pin the native derivation to the python oracle at the ends
            for i in (have, n - 1):
                expect = cv.hash_to_curve(label + b"/"
                                          + i.to_bytes(8, "big"))
                if _pt_at(tail, i - have) != expect:
                    tail = None
                    break
        if tail is None:                   # no native lib: python fallback
            buf = bytearray()
            for i in range(have, n):
                x, y = cv.hash_to_curve(label + b"/"
                                        + i.to_bytes(8, "big"))
                buf += x.to_bytes(32, "little") \
                    + y.to_bytes(32, "little") + b"\x00"
            tail = bytes(buf)
        packed = packed + tail
        dirty = True
    if dirty:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = path2 + ".tmp.%d" % os.getpid()
            with open(tmp, "wb") as fh:
                fh.write(packed + hashlib.sha256(packed).digest())
            os.replace(tmp, path2)
        except Exception:
            pass
    _GENS_MEM[mkey] = packed
    return packed[:65 * n]


def _cached_gens(cv: Curve, label: bytes, n: int) -> List[Point]:
    """Generator list as python int tuples (compat wrapper over the packed
    primary; prefer packed for hot paths)."""
    from ..ec.native_msm import _unpack_points
    return _unpack_points(_cached_gens_packed(cv, label, n), n)


_BLIND_H: dict = {}


def shared_blinding_gen(cv: Curve = PALLAS) -> Point:
    """One global blinding generator H per curve (the reference derives its
    vector gens with the scalar gen's blinding gen, commitment.rs:178-182 —
    a single H per curve is required for the IPA's combined-blind
    algebra)."""
    if cv.name not in _BLIND_H:
        _BLIND_H[cv.name] = cv.hash_to_curve(b"reef/blind")
    return _BLIND_H[cv.name]


def _device_msm_mode() -> str:
    """REEF_DEVICE_MSM gate: "0" = host only, "1" = force the device
    route (on the selected engine device, the CPU included: there the
    kernels' plain versions run), "auto" = engage on a CUDA engine device
    for commits of at least DEVICE_MSM_MIN_N values (utils.device)."""
    import os
    return os.environ.get("REEF_DEVICE_MSM", "auto")


_MSM_HOST_PIN = threading.local()


def pin_host_msm() -> None:
    """Pin the CALLING THREAD's Pedersen MSMs to the host path.  The
    framework's consistency/CAP thread runs concurrently with the
    CompressedSNARK (framework.py prove overlap); its MSMs are small
    enough that the host path loses nothing, and keeping them off the
    card leaves one thread launching device work at a time."""
    _MSM_HOST_PIN.on = True


def _device_msm_on(n: Optional[int] = None) -> bool:
    if getattr(_MSM_HOST_PIN, "on", False):
        return False
    mode = _device_msm_mode()
    if mode == "1":
        return True
    if mode != "auto":
        return False
    from ..utils.device import device_profile
    if device_profile() == "cpu":
        return False
    return n is None or n >= DEVICE_MSM_MIN_N


DEVICE_MSM_MIN_N = 256          # below this the host MSM always wins
DEVICE_ROWS_MIN_N = 4096        # tree-kernel shape floor for row batches


def _pack_H(cv: Curve, H: Point) -> bytes:
    from ..ec.native_msm import _pack_points
    return bytes(_pack_points([H]))


class PedersenGens:
    def __init__(self, cv: Curve, label: bytes, n: int):
        self.cv = cv
        self.n = n
        self._label = label
        self._packed = _cached_gens_packed(cv, label, n)
        self._G = None
        self.H = shared_blinding_gen(cv)
        self._device_basis = None

    def native_basis(self):
        """Native basis handle: points loaded + IFMA-converted once per
        (curve, label, n), shared process-wide — every per-fold commit and
        IPA basis MSM then skips the ~45ms per-call load at 2^16."""
        from ..ec.native_msm import basis_handle
        return basis_handle(self.cv, (self.cv.name, self._label, self.n),
                            self._packed)

    @property
    def G(self) -> List[Point]:
        """Generators as int tuples — materialized lazily; the native
        paths consume packed_G() and never pay this."""
        if self._G is None:
            from ..ec.native_msm import _unpack_points
            self._G = _unpack_points(self._packed, self.n)
        return self._G

    def packed_G(self):
        """Native-packed basis for indexed MSMs (the primary form)."""
        return self._packed

    def device_G(self):
        """Device-resident basis for the Pippenger MSM (ec.msm_v3), on the
        engine device; cached, one upload per gens set."""
        if self._device_basis is None:
            from ..ec.msm import kernels_for
            from ..ec.msm_v3 import DeviceBasisV3
            self._device_basis = DeviceBasisV3(kernels_for(self.cv), self.G)
        return self._device_basis

    def _msm_device_route(self, values: List[int]) -> Point:
        """Device MSM on the single engine device."""
        basis = self.device_G()
        from ..ec.msm_v3 import msm_device_v3
        return msm_device_v3(basis.ck, list(values), basis)

    def commit(self, values: List[int], blind: int) -> Point:
        cv = self.cv
        if len(values) >= DEVICE_MSM_MIN_N and _device_msm_on(len(values)):
            base = self._msm_device_route(values)
        else:
            try:
                from ..ec.native_msm import msm_packed
                base = msm_packed(cv, values, self.packed_G(),
                                  handle=self.native_basis())
            except RuntimeError:
                base = cv.msm(list(values), self.G[:len(values)])
        return cv.add(cv.mul(blind, self.H), base)

    def commit_rows(self, flat: List[int], blinds: List[int]
                    ) -> Optional[List[Point]]:
        """All row commitments of a matrix in ONE native call (basis loaded
        once, rows threaded, magnitude-capped windows — the Hyrax doc
        commit); returns None when the native library is unavailable.

        Wide matrices (row length >= DEVICE_ROWS_MIN_N, the tree kernel's
        chunk floor) route to the device when the REEF_DEVICE_MSM gate
        engages: every row through ec.msm_v3.msm_device_v3_rows, blinds
        folded in via one native fixed-base call."""
        n_rows = len(blinds)
        assert n_rows and len(flat) == n_rows * self.n
        if self.n >= DEVICE_ROWS_MIN_N and _device_msm_on(n_rows * self.n):
            from ..ec.msm_v3 import msm_device_v3_rows
            from ..ec.native_msm import msm_rows as native_rows
            rows = [flat[r * self.n:(r + 1) * self.n]
                    for r in range(n_rows)]
            base = msm_device_v3_rows(self.device_G().ck, rows,
                                      self.device_G())
            hpacked = _pack_H(self.cv, self.H)
            bpts = native_rows(self.cv, n_rows, 1, [0] * n_rows, blinds,
                               hpacked, self.H)
            if bpts is None:
                bpts = [self.cv.mul(b, self.H) for b in blinds]
            return [self.cv.add(p, bp) for p, bp in zip(base, bpts)]
        from ..ec.native_msm import msm_rows
        return msm_rows(self.cv, n_rows, self.n, flat, blinds,
                        self.packed_G(), self.H)


def eq_evals(f: F.HostField, point: List[int]) -> List[int]:
    """All 2^l values of ~eq(point, bits(j)), point MSB-first."""
    p = f.p
    if len(point) >= 8:
        from ..ops import native_fieldvec as FV
        if FV.available() and p in FV.FIELD_ID:
            return FV.eq_evals_native(point, p)
    out = [1]
    for q in point:
        # MSB-first: each new coordinate becomes the LOWEST index bit of the
        # table built so far, so earlier coordinates end up as higher bits
        out = [x for v in out for x in (v * (1 - q) % p, v * q % p)]
    return out


# ---------------------------------------------------------------------------
# Hyrax polynomial commitment
# ---------------------------------------------------------------------------

@dataclass
class HyraxCommitment:
    row_commits: List[Point]          # one Pedersen vector commit per row
    n_vars: int
    l_left: int
    l_right: int


@dataclass
class SigmaEvalProof:
    """ZK proof that <w, R> = v for C_w = Com(w; rho), C_v = Com(v; r_v)."""
    A: Tuple[int, int]                # Com(s; r_s) compressed
    B: Tuple[int, int]                # Com_sc(<s,R>; r_B) compressed
    z: List[int]                      # s + e*w
    z_rho: int
    z_B: int


def factored_lens(n_vars: int) -> Tuple[int, int]:
    """(left, right) split of the MLE variables (left = rows)."""
    left = n_vars // 2
    right = n_vars - left
    return left, right


_SC_GENS: dict = {}


def shared_scalar_gens(cv: Curve = PALLAS) -> PedersenGens:
    """One global scalar-commitment generator pair per curve (the reference
    shares `single_gens` across the CAP keys and Hyrax,
    commitment.rs:171-187)."""
    if cv.name not in _SC_GENS:
        _SC_GENS[cv.name] = PedersenGens(cv, b"reef/scalar", 1)
    return _SC_GENS[cv.name]


_VEC_GENS_CACHE: dict = {}


class HyraxPC:
    def __init__(self, label: bytes, n_vars: int):
        self.cv = PALLAS
        self.f = F.FQ                      # scalars of pallas
        self.n_vars = n_vars
        self.l_left, self.l_right = factored_lens(n_vars)
        self.n_rows = 1 << self.l_left
        self.n_cols = 1 << self.l_right
        key = (label, self.n_cols)
        if key not in _VEC_GENS_CACHE:
            _VEC_GENS_CACHE[key] = PedersenGens(self.cv, label + b"/vec",
                                                self.n_cols)
        self.vec_gens = _VEC_GENS_CACHE[key]
        self.sc_gens = shared_scalar_gens()

    def commit(self, coeffs: List[int], blinds: Optional[List[int]] = None
               ) -> Tuple[HyraxCommitment, List[int]]:
        assert len(coeffs) == self.n_rows * self.n_cols
        if blinds is None:
            import secrets
            blinds = [secrets.randbelow(self.f.p) for _ in range(self.n_rows)]
        # the row MSMs are MANY SMALL MSMs over a shared basis: the host
        # row-batched native call (basis loaded once, rows threaded) beats
        # per-row device launches for typical sqrt-factored shapes; wide
        # rows (>= DEVICE_ROWS_MIN_N cols, fused-tree territory at >1M
        # pts/s) route to one all-rows device dispatch inside commit_rows
        rows = self.vec_gens.commit_rows(coeffs, blinds)
        if rows is None:
            rows = [self.vec_gens.commit(
                        coeffs[j * self.n_cols:(j + 1) * self.n_cols],
                        blinds[j]) for j in range(self.n_rows)]
        return HyraxCommitment(rows, self.n_vars, self.l_left,
                               self.l_right), blinds

    def _split_point(self, q: List[int]) -> Tuple[List[int], List[int]]:
        assert len(q) == self.n_vars
        return q[:self.l_left], q[self.l_left:]

    def evaluate(self, coeffs: List[int], q: List[int]) -> int:
        p = self.f.p
        qL, qR = self._split_point(q)
        L = eq_evals(self.f, qL)
        R = eq_evals(self.f, qR)
        total = 0
        for j in range(self.n_rows):
            row = coeffs[j * self.n_cols:(j + 1) * self.n_cols]
            total += L[j] * sum(r * c % p for r, c in zip(R, row))
        return total % p

    def _fold_lr(self, coeffs, blinds, q):
        p = self.f.p
        qL, qR = self._split_point(q)
        L = eq_evals(self.f, qL)
        R = eq_evals(self.f, qR)
        w = []
        for c in range(self.n_cols):
            w.append(sum(L[j] * coeffs[j * self.n_cols + c] for j in
                         range(self.n_rows)) % p)
        rho = sum(L[j] * blinds[j] for j in range(self.n_rows)) % p \
            if blinds is not None else None
        return L, R, w, rho

    def prove_eval(self, coeffs: List[int], commit: HyraxCommitment,
                   blinds: List[int], q: List[int], v: int, v_blind: int,
                   transcript: Transcript, sigma: bool = False):
        """Prove committed-poly(q) == v where C_v = Com_sc(v; v_blind).

        Default: log-round IPA (backend.ipa); sigma=True uses the
        O(sqrt N) sigma protocol (kept for comparison/testing)."""
        import secrets
        p = self.f.p
        cv = self.cv
        L, R, w, rho = self._fold_lr(coeffs, blinds, q)

        for pt in commit.row_commits:
            transcript.append_point(b"row", cv, pt)
        transcript.append(b"q", q)

        if not sigma:
            from .ipa import ipa_prove
            C_w = cv.msm(L, commit.row_commits)
            C_v = self.sc_gens.commit([v % p], v_blind)
            return ipa_prove(self.vec_gens, self.sc_gens.G[0], w, rho, R,
                             v % p, v_blind, C_w, C_v, transcript)

        s = [secrets.randbelow(p) for _ in range(self.n_cols)]
        r_s = secrets.randbelow(p)
        r_B = secrets.randbelow(p)
        A = self.vec_gens.commit(s, r_s)
        sR = sum(si * ri % p for si, ri in zip(s, R)) % p
        Bp = self.sc_gens.commit([sR], r_B)
        transcript.append_point(b"A", cv, A)
        transcript.append_point(b"B", cv, Bp)
        e = transcript.challenge(b"e", cv.order)
        z = [(si + e * wi) % p for si, wi in zip(s, w)]
        z_rho = (r_s + e * rho) % p
        z_B = (r_B + e * v_blind) % p
        return SigmaEvalProof(cv.compress(A), cv.compress(Bp), z, z_rho, z_B)

    def verify_eval(self, commit: HyraxCommitment, q: List[int],
                    v_commit: Point, proof, transcript: Transcript) -> bool:
        p = self.f.p
        cv = self.cv
        qL, qR = self._split_point(q)
        L = eq_evals(self.f, qL)
        R = eq_evals(self.f, qR)
        C_w = cv.msm(L, commit.row_commits)

        for pt in commit.row_commits:
            transcript.append_point(b"row", cv, pt)
        transcript.append(b"q", q)

        if not isinstance(proof, SigmaEvalProof):
            from .ipa import ipa_verify
            return ipa_verify(self.vec_gens, self.sc_gens.G[0], R, C_w,
                              v_commit, proof, transcript)

        A = cv.decompress(proof.A)
        Bp = cv.decompress(proof.B)
        transcript.append_point(b"A", cv, A)
        transcript.append_point(b"B", cv, Bp)
        e = transcript.challenge(b"e", cv.order)
        # Com(z; z_rho) == A + e*C_w
        lhs = self.vec_gens.commit(proof.z, proof.z_rho)
        rhs = cv.add(A, cv.mul(e, C_w))
        if lhs != rhs:
            return False
        # Com_sc(<z,R>; z_B) == B + e*C_v
        zR = sum(zi * ri % p for zi, ri in zip(proof.z, R)) % p
        lhs2 = self.sc_gens.commit([zR], proof.z_B)
        rhs2 = cv.add(Bp, cv.mul(e, v_commit))
        return lhs2 == rhs2


# ---------------------------------------------------------------------------
# Schnorr equality proof (hybrid split check)
# ---------------------------------------------------------------------------

@dataclass
class EqualityProof:
    alpha: Tuple[int, int]
    z: int


def prove_equality(gens: PedersenGens, c1: Point, r1: int, c2: Point,
                   r2: int) -> EqualityProof:
    """Prove C1, C2 commit to the same value (knowledge of r1 - r2)."""
    import secrets
    cv = gens.cv
    r = secrets.randbelow(cv.order)
    alpha = cv.mul(r, gens.H)
    t = Transcript(b"eq_proof")
    t.append_point(b"C1", cv, c1)
    t.append_point(b"C2", cv, c2)
    t.append_point(b"alpha", cv, alpha)
    c = t.challenge(b"c", cv.order)
    z = (c * (r1 - r2) + r) % cv.order
    return EqualityProof(cv.compress(alpha), z)


def verify_equality(gens: PedersenGens, c1: Point, c2: Point,
                    proof: EqualityProof) -> bool:
    cv = gens.cv
    alpha = cv.decompress(proof.alpha)
    t = Transcript(b"eq_proof")
    t.append_point(b"C1", cv, c1)
    t.append_point(b"C2", cv, c2)
    t.append_point(b"alpha", cv, alpha)
    c = t.challenge(b"c", cv.order)
    # z*H == c*(C1 - C2) + alpha
    lhs = cv.mul(proof.z, gens.H)
    rhs = cv.add(cv.mul(c, cv.add(c1, cv.neg(c2))), alpha)
    return lhs == rhs


# ---------------------------------------------------------------------------
# Doc commitment + consistency
# ---------------------------------------------------------------------------

def _commit_hash(rows: List[Point]) -> int:
    """Poseidon-over-Fp hash of compressed row commitments -> Fq element."""
    fp = F.FP
    data = []
    for pt in rows:
        x, flag = PALLAS.compress(pt)
        data.append(x % fp.p)
        data.append(flag)
    io = IOPattern([("absorb", len(data)), ("squeeze", 1)],
                   domain=b"doc_commit_hash")
    sp = HostSponge(fp, io)
    sp.absorb(data)
    out = sp.squeeze(1)[0]
    return out % (1 << 254) % F.Q


@dataclass
class NLDocCommitment:
    n_vars: int
    commit: HyraxCommitment
    doc_commit_hash: int
    hash_salt: int
    # prover-only state
    _coeffs: Optional[List[int]] = None
    _blinds: Optional[List[int]] = None

    def public_part(self) -> "NLDocCommitment":
        return NLDocCommitment(self.n_vars, self.commit,
                               self.doc_commit_hash, self.hash_salt)


@dataclass
class ConsistencyProof:
    hash_d: int
    v_commit: Tuple[int, int]
    v_prime_commit: Optional[Tuple[int, int]]
    eval_proof: SigmaEvalProof
    running_q: List[int]
    eq_proof: Optional[EqualityProof]
    l_commit: Optional[Tuple[int, int]]
    cap_proof: Optional[object] = None  # Spartan CAP (wired in spartan.py)


def commit_doc(udoc: List[int], seed: Optional[int] = None) -> NLDocCommitment:
    """Commit to the (padded) document MLE (commitment.rs:133-212)."""
    import secrets
    f = F.FQ
    n = next_power_of_two(len(udoc))
    coeffs = [x % f.p for x in udoc] + [0] * (n - len(udoc))
    n_vars = logmn(n)
    pc = HyraxPC(b"doc", n_vars)
    if seed is not None:
        import random
        rng = random.Random(seed)
        blinds = [rng.randrange(f.p) for _ in range(pc.n_rows)]
        salt = rng.randrange(f.p)
    else:
        blinds = None
        salt = secrets.randbelow(f.p)
    commit, blinds = pc.commit(coeffs, blinds)
    return NLDocCommitment(n_vars, commit, _commit_hash(commit.row_commits),
                           salt, coeffs, blinds)


def adjust_running_q(dc_q_len: int, q: List[int],
                     proj_chunk_idx: Optional[List[int]], proj: bool,
                     hybrid: bool) -> List[int]:
    """Remap the circuit's running q onto the full committed doc
    (commitment.rs:305-345): prepend projection chunk bits / strip hybrid
    high bits."""
    if not hybrid and not proj:
        assert len(q) == dc_q_len
        return list(q)
    if hybrid and not proj:
        assert len(q) >= dc_q_len + 1
        return list(q[len(q) - dc_q_len:])
    if proj and not hybrid:
        q_add = list(proj_chunk_idx)
        return q_add + list(q)
    q_add = list(proj_chunk_idx)
    new_q_len = dc_q_len - len(q_add)
    assert len(q) >= new_q_len + 1
    return q_add + list(q[len(q) - new_q_len:])


def prove_consistency(dc: NLDocCommitment, table: List[int],
                      proj_chunk_idx: Optional[List[int]], q: List[int],
                      v: int, proj: bool, hybrid: bool,
                      v_blind: Optional[int] = None) -> ConsistencyProof:
    """Link the final doc running claim to the commitment
    (commitment.rs:214-285).  `v_blind` may be supplied so the same
    v-commitment can be shared with the CAP proof."""
    import secrets
    f = F.FQ
    cv = PALLAS
    pc = HyraxPC(b"doc", dc.n_vars)
    cap_d = StepCircuit._hide_host(v, dc.hash_salt)

    running_q = adjust_running_q(dc.n_vars, q, proj_chunk_idx, proj, hybrid)

    if v_blind is None:
        v_blind = secrets.randbelow(f.p)
    v_commit = pc.sc_gens.commit([v % f.p], v_blind)

    t = Transcript(b"dot_prod_proof")
    if not hybrid:
        proof = pc.prove_eval(dc._coeffs, dc.commit, dc._blinds, running_q,
                              v % f.p, v_blind, t)
        return ConsistencyProof(cap_d, cv.compress(v_commit), None, proof,
                                running_q, None, None)
    # hybrid: v = (1-q0)*t + q0*v'
    v_prime = pc.evaluate(dc._coeffs, running_q)
    vp_blind = secrets.randbelow(f.p)
    vp_commit = pc.sc_gens.commit([v_prime], vp_blind)
    proof = pc.prove_eval(dc._coeffs, dc.commit, dc._blinds, running_q,
                          v_prime, vp_blind, t)
    q_prime = q[1:]
    t_val = verifier_mle_eval(f, table, q_prime)
    q0 = q[0] % f.p
    assert ((1 - q0) * t_val + q0 * v_prime - v) % f.p == 0
    # l = q0*C_v' + (1-q0)*Com(t; 0); t is PUBLIC (table MLE at public q'),
    # so it is committed unblinded and the verifier re-derives C_l itself —
    # unlike the reference, which lets the prover supply a blinded t-commit
    # (commitment.rs:407-431), leaving l_commit unbound.
    t_commit = pc.sc_gens.commit([t_val], 0)
    l_blind = vp_blind * q0 % f.p
    l_commit = cv.add(cv.mul(q0, vp_commit),
                      cv.mul((1 - q0) % f.p, t_commit))
    eqp = prove_equality(pc.sc_gens, v_commit, v_blind, l_commit, l_blind)
    return ConsistencyProof(cap_d, cv.compress(v_commit),
                            cv.compress(vp_commit), proof, running_q, eqp,
                            cv.compress(l_commit))


def verify_consistency(dc: NLDocCommitment, proof: ConsistencyProof,
                       table: Optional[List[int]] = None,
                       q: Optional[List[int]] = None) -> bool:
    """commitment.rs:446-475.  For hybrid, re-derives C_t from the public
    table MLE eval at q[1:] and checks the split equality proof."""
    f = F.FQ
    cv = PALLAS
    pc = HyraxPC(b"doc", dc.n_vars)
    t = Transcript(b"dot_prod_proof")
    v_commit = cv.decompress(proof.v_commit)
    if proof.eq_proof is not None:
        assert table is not None and q is not None, \
            "hybrid verification needs the public table + running q"
        vp_commit = cv.decompress(proof.v_prime_commit)
        if not pc.verify_eval(dc.commit, proof.running_q, vp_commit,
                              proof.eval_proof, t):
            return False
        # re-derive C_l from public data: t = T~(q[1:]) committed unblinded
        t_val = verifier_mle_eval(f, table, q[1:])
        q0 = q[0] % f.p
        t_commit = pc.sc_gens.commit([t_val], 0)
        l_commit = cv.add(cv.mul(q0, vp_commit),
                          cv.mul((1 - q0) % f.p, t_commit))
        if cv.compress(l_commit) != proof.l_commit:
            return False
        return verify_equality(pc.sc_gens, v_commit, l_commit, proof.eq_proof)
    return pc.verify_eval(dc.commit, proof.running_q, v_commit,
                          proof.eval_proof, t)


def final_clear_checks(stack_ptr: int, table: List[int],
                       final_q: Optional[List[int]],
                       final_v: Optional[int]) -> bool:
    """commitment.rs:512-535."""
    if stack_ptr != 0:
        return False
    if final_q is not None and final_v is not None:
        if verifier_mle_eval(F.FQ, table, final_q) != final_v % F.Q:
            return False
    return True
