"""Log-round inner-product argument (Bulletproofs-style, with blinds).

The reference's evaluation engine (nova's ipa_pc, used inside Hyrax eval
proofs and Spartan, commitment.rs:24-26).  Relation proven:

    C_w = <w, G> + rho*H          (vector commitment, blinded)
    C_v = v*G_s + r_v*H           (scalar commitment, blinded)
    <w, R> = v                    (R public)

Protocol: combine P = C_w + tau*C_v for a transcript challenge tau, giving a
commitment with G_s-coefficient tau*v; run log2(n) halving rounds with
blinded cross terms L/R; finally open the folded scalar and blind.  v itself
is never revealed (the final scalars reveal only challenge-folded
combinations, matching the reference's hiding level).

Verifier cost: one O(n) MSM for the folded basis (s-vector trick) + O(log n)
group ops.  Proof size: 2*log2(n) points + 2 scalars.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List, Tuple

from ..ec.pasta import PALLAS, Point
from ..ops import field as F
from ..utils.metrics import count, span
from . import routes
from .commitment import PedersenGens, Transcript

f = F.FQ
cv = PALLAS


@dataclass
class IpaProof:
    Ls: List[Tuple[int, int]]
    Rs: List[Tuple[int, int]]
    a_final: int
    rho_final: int


def _absorb_setup(t: Transcript, C_w: Point, C_v: Point, R_pub: List[int],
                  cv=cv):
    t.append_point(b"C_w", cv, C_w)
    t.append_point(b"C_v", cv, C_v)
    # one blob absorb of the 32B-LE packed form: the per-element
    # transcript recursion was ~0.12s of every verify at n=2^15, and a
    # PackedVec R (eq_evals_native) absorbs its raw bytes with no
    # int round-trip at all.  Prover and verifier share this function,
    # so the encoding only needs to be consistent, not canonical-BE.
    from ..ops.native_fieldvec import pack
    t.append(b"R", pack(R_pub, cv.order))
    return t.challenge(b"ipa_tau", cv.order)


def _batch_inverse(xs: List[int], p: int) -> List[int]:
    """Montgomery batch inversion: ONE pow + 3(n-1) muls.

    Raises on any element ≡ 0 mod p (matching per-element pow(x,-1,p)):
    a zero would silently poison EVERY output via the prefix product."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        if x % p == 0:
            raise ValueError("_batch_inverse: element ≡ 0 mod p")
        prefix[i + 1] = prefix[i] * x % p
    inv_all = pow(prefix[n], p - 2, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % p
        inv_all = inv_all * xs[i] % p
    return out


def _round_engine(gens: PedersenGens, w, R):
    """The round engine of one proof, where backend/routes.py routes the
    IPA of len(w) values: `IpaMesh` over the basis the process mesh
    holds, `IpaDevice` (ec/ipa_device.py) on the card, else the native
    host engine, else None (the python rounds below).  Counts `IPA
    mesh`, `IPA device` or `IPA host`."""
    on = routes.route("ipa", len(w))
    if on == routes.MESH:
        from ..ec.ipa_device import IpaMesh
        from ..parallel.mesh import process_mesh
        count("IPA", "mesh")
        return IpaMesh(gens, w, R, process_mesh())
    if on == routes.CARD:
        from ..ec.ipa_device import IpaDevice
        count("IPA", "device")
        return IpaDevice(gens, w, R)
    count("IPA", "host")
    if len(w) < 2:
        return None
    try:
        from ..ec.native_msm import IpaNative
        return IpaNative(gens.cv, w, R, gens.packed_G())
    except RuntimeError:
        return None


def ipa_prove(gens: PedersenGens, G_s: Point, w: List[int], rho: int,
              R_pub: List[int], v: int, r_v: int, C_w: Point, C_v: Point,
              t: Transcript) -> IpaProof:
    """Prover, in the span `Prover ipa`."""
    with span("Prover", "ipa"):
        return _ipa_prove(gens, G_s, w, rho, R_pub, v, r_v, C_w, C_v, t)


def _ipa_prove(gens: PedersenGens, G_s: Point, w: List[int], rho: int,
               R_pub: List[int], v: int, r_v: int, C_w: Point, C_v: Point,
               t: Transcript) -> IpaProof:
    """Prover.  The folded basis is never materialized: after k rounds the
    folded G'_i is a challenge-product combination of original points, so
    each L/R is computed as one MSM over (half of) the ORIGINAL basis with
    expanded scalars w[..]*coeff[j].  This replaces the 2n full scalar
    multiplications of explicit basis folding with 2*log(n) Pippenger MSMs
    (the round-1 IPA spent >70%% of prover time folding G)."""
    cv = gens.cv
    p = cv.order
    n_orig = len(w)
    n = n_orig
    assert n & (n - 1) == 0 and len(R_pub) == n
    tau = _absorb_setup(t, C_w, C_v, R_pub, cv)

    from ..ops.native_fieldvec import PackedVec
    H = gens.H
    if not (isinstance(w, PackedVec) and w.p == p):   # PackedVec: canonical
        w = [x % p for x in w]
    if isinstance(R_pub, PackedVec) and R_pub.p == p:
        R = R_pub
    else:
        R = [x % p for x in R_pub]
    rho_p = (rho + tau * r_v) % p

    # round engine: w/R/coeff folds, cross dots, and the two
    # expanded-scalar MSMs per round run on the card (ec/ipa_device.py) or
    # in C (native/msm.cpp ipa_*); only the transcript, blinds, and G_s/H
    # terms stay here
    eng = _round_engine(gens, w, R)
    if eng is not None:
        Ls, Rs = [], []
        n_cur = n
        while n_cur > 1:
            cL, cR, mL, mR = eng.cross()
            r_L = secrets.randbelow(p)
            r_R = secrets.randbelow(p)
            L = cv.add(cv.add(mL, cv.mul(tau * cL % p, G_s)),
                       cv.mul(r_L, H))
            Rp = cv.add(cv.add(mR, cv.mul(tau * cR % p, G_s)),
                        cv.mul(r_R, H))
            Ls.append(cv.compress(L))
            Rs.append(cv.compress(Rp))
            t.append(b"L", list(cv.compress(L)))
            t.append(b"R", list(cv.compress(Rp)))
            x = t.challenge(b"ipa_x", cv.order)
            xi = pow(x, -1, p)
            eng.fold(x)
            rho_p = (x * x % p * r_L + rho_p + xi * xi % p * r_R) % p
            n_cur //= 2
        a_final = eng.final()
        eng.close()
        return IpaProof(Ls, Rs, a_final, rho_p)

    coeff = [1] * n_orig          # G'_{j mod cur} accumulates coeff[j]*G[j]

    Ls, Rs = [], []
    while n > 1:
        half = n // 2
        w_lo, w_hi = w[:half], w[half:]
        R_lo, R_hi = R[:half], R[half:]
        r_L = secrets.randbelow(p)
        r_R = secrets.randbelow(p)
        cL = sum(a * b for a, b in zip(w_lo, R_hi)) % p
        cR = sum(a * b for a, b in zip(w_hi, R_lo)) % p
        # <w_lo, G'_hi> and <w_hi, G'_lo> over the original basis
        sL, iL, sR, iR = [], [], [], []
        for j in range(n_orig):
            pos = j % n
            if pos >= half:
                s = w_lo[pos - half] * coeff[j] % p
                if s:
                    sL.append(s)
                    iL.append(j)
            else:
                s = w_hi[pos] * coeff[j] % p
                if s:
                    sR.append(s)
                    iR.append(j)
        try:
            from ..ec.native_msm import msm_packed
            packed = gens.packed_G()
            h = gens.native_basis()
            mL = msm_packed(cv, sL, packed, iL, handle=h)
            mR = msm_packed(cv, sR, packed, iR, handle=h)
        except RuntimeError:
            G_orig = gens.G
            mL = cv.msm(sL, [G_orig[j] for j in iL])
            mR = cv.msm(sR, [G_orig[j] for j in iR])
        L = cv.add(cv.add(mL, cv.mul(tau * cL % p, G_s)),
                   cv.mul(r_L, H))
        Rp = cv.add(cv.add(mR, cv.mul(tau * cR % p, G_s)),
                    cv.mul(r_R, H))
        Ls.append(cv.compress(L))
        Rs.append(cv.compress(Rp))
        t.append(b"L", list(cv.compress(L)))
        t.append(b"R", list(cv.compress(Rp)))
        x = t.challenge(b"ipa_x", cv.order)
        xi = pow(x, -1, p)
        w = [(x * a + xi * b) % p for a, b in zip(w_lo, w_hi)]
        R = [(xi * a + x * b) % p for a, b in zip(R_lo, R_hi)]
        for j in range(n_orig):
            coeff[j] = coeff[j] * (xi if (j % n) < half else x) % p
        rho_p = (x * x % p * r_L + rho_p + xi * xi % p * r_R) % p
        n = half

    return IpaProof(Ls, Rs, w[0], rho_p)


def ipa_verify(gens: PedersenGens, G_s: Point, R_pub: List[int],
               C_w: Point, C_v: Point, proof: IpaProof,
               t: Transcript) -> bool:
    cv = gens.cv
    p = cv.order
    n = len(R_pub)
    if n & (n - 1) or len(proof.Ls) != n.bit_length() - 1:
        return False
    tau = _absorb_setup(t, C_w, C_v, R_pub, cv)

    xs = []
    for Lc, Rc in zip(proof.Ls, proof.Rs):
        t.append(b"L", list(Lc))
        t.append(b"R", list(Rc))
        xs.append(t.challenge(b"ipa_x", cv.order))

    # folded basis coefficients: s_i = prod_k x_k^(+-1 by bit); round k
    # splits on bit (log n - 1 - k), hi half gets x_k.  Built by doubling
    # (n muls), with ONE batched inversion for all rounds' x^{-1}.
    xis = _batch_inverse(xs, p) if xs else []
    s = [1]
    for x, xi in zip(xs, xis):
        s = [v * m % p for v in s for m in (xi, x)]
    try:
        from ..ec.native_msm import msm_packed
        G_final = msm_packed(cv, s, gens.packed_G(),
                             handle=gens.native_basis())
    except RuntimeError:
        G_final = cv.msm(s, gens.G[:n])
    # R folds with the same x^{-1}/x pattern as G: R_final = <s, R>
    R_final = sum(si * ri % p for si, ri in zip(s, R_pub)) % p

    # One small MSM decides everything: P_final == rhs rearranged as
    #   C_w + tau*C_v + sum x^2 L + sum x^-2 R
    #     - a*G_final - (tau*a*R_final)*G_s - rho_final*H == identity
    # (python double-and-add per term was ~0.08s of every verify; the
    # native Straus path batches the ~35 points in one call).
    a = proof.a_final % p
    scalars = [tau] + [x * x % p for x in xs] + [xi * xi % p for xi in xis]
    points = [C_v] + [cv.decompress(Lc) for Lc in proof.Ls] \
        + [cv.decompress(Rc) for Rc in proof.Rs]
    scalars += [(-a) % p, (-(tau * a % p) * R_final) % p,
                (-proof.rho_final) % p]
    points += [G_final, G_s, gens.H]
    try:
        from ..ec.native_msm import msm_native
        acc = msm_native(cv, scalars, points)
    except RuntimeError:
        acc = cv.msm(scalars, points)
    return cv.add(C_w, acc) is None      # identity <=> P_final == rhs
