"""Spartan-style SNARK for a relaxed R1CS instance (final compression).

Plays the role of the reference's CompressedSNARK (nova-snark's
spartan::RelaxedR1CSSNARK + ipa_pc, framework.rs:695), built on this repo's
sumcheck + Hyrax primitives:

  sumcheck 1 (cubic rounds):
      0 = sum_y eq(tau,y) * (Az~(y) * Bz~(y) - u*Cz~(y) - E~(y))
  -> claims vA,vB,vC at rx; vE proven against the folded E commitment.
  sumcheck 2 (quadratic rounds), batching challenge rr:
      vA + rr*vB + rr^2*vC = sum_y M~(rx,y) * Z~(y),
      M = A + rr*B + rr^2*C
  -> vz at ry; the verifier evaluates the sparse matrix MLEs itself (O(nnz),
  the non-preprocessing "uniform" Spartan flavor; SPARK-style sparse
  commitments are a later upgrade), and vz splits as
      vz = (1-ry0) * W~(ry[1:]) + ry0 * P~(ry[1:])
  with P = (u, x, 0...) public and W~ proven against the folded W commitment.
  sumcheck 3 (batched opening, quadratic rounds), challenge gamma:
      vE + gamma*vW = sum_b eq(rx,b)*E(b) + gamma*eq(ry[1:],b)*W(b)
  moves both eval claims to one random point rho; with challenge delta the
  polynomials combine homomorphically over the SHARED per-curve basis
  (VectorCommitter) into E + delta*W, opened with ONE IPA — the nova
  fork's ipa_pc batched-evaluation shape, halving compress MSM work.

Round evaluations are sent as value lists [g(0)..g(d)]; the verifier
Lagrange-interpolates g(r).  Claimed evaluation values are public (matching
the reference's non-zk compressed SNARK; the document stays hidden behind
the hash/salt layer of the step circuit).

Also provides the CAP (commit-and-prove) flavor used by the consistency
check (commitment.rs:257-271): same SNARK over the ConsistencyCircuit
Poseidon(v,salt)=d, plus a Hyrax eval proof opening W at v's wire index,
tied to the public Pedersen commitment C_v by an equality proof.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..ec.pasta import PALLAS
from ..ops import field as F
from ..utils.metrics import span
from .commitment import (HyraxPC, SigmaEvalProof, Transcript, eq_evals,
                         prove_equality, shared_scalar_gens, verify_equality)
from .ipa import ipa_prove, ipa_verify
from .costs import logmn, next_power_of_two
from .nova import (R1CSShape, RelaxedInstance, RelaxedWitness,
                   VectorCommitter, absorb_commit)

f = F.FQ
cv = PALLAS


_LAG_DEN_INV: dict = {}


def _lagrange(evals: List[int], r: int, p: int = None) -> int:
    """Evaluate the degree-(len-1) poly with values evals at 0..d, at r.
    Denominator inverses depend only on (degree, p): memoized (the pow()
    calls were ~0.2s of every verify, profiled round 3)."""
    if p is None:
        p = f.p
    d = len(evals) - 1
    dens = _LAG_DEN_INV.get((d, p))
    if dens is None:
        dens = []
        for i in range(d + 1):
            den = 1
            for j in range(d + 1):
                if j != i:
                    den = den * ((i - j) % p) % p
            dens.append(pow(den, p - 2, p))
        _LAG_DEN_INV[(d, p)] = dens
    total = 0
    for i, yi in enumerate(evals):
        num = 1
        for j in range(d + 1):
            if j != i:
                num = num * ((r - j) % p) % p
        total = (total + yi * num % p * dens[i]) % p
    return total


def _fold_table(tab: List[int], r: int, p: int = None):
    if p is None:
        p = f.p
    half = len(tab) // 2
    return [(tab[b] * (1 - r) + tab[b + half] * r) % p
            for b in range(half)]


def _eval_at(tab, b, half, t, p: int = None):
    return (tab[b] + t * (tab[b + half] - tab[b])) % (p or f.p)


@dataclass
class SpartanProof:
    sc1: List[List[int]]          # per-round [g(0), g(2), g(3)] (g(1)
    vA: int                       # omitted: verifier derives claim-g(0))
    vB: int
    vC: int
    vE: int
    sc2: List[List[int]]          # per-round [g(0), g(2)]
    vW: int
    sc3: List[List[int]]          # batched-opening reduction [g(0), g(2)]
    vE2: int                      # E~(rho)
    vW2: int                      # W~(rho)
    eval: SigmaEvalProof          # ONE IPA: (E + delta*W) opened at rho


def _absorb_instance(t: Transcript, shape: R1CSShape, U: RelaxedInstance,
                     cv=None):
    t.append(b"shape", shape.digest)
    absorb_commit(t, b"W", U.comm_W, cv)
    absorb_commit(t, b"E", U.comm_E, cv)
    t.append(b"u", U.u)
    t.append(b"x", U.x)


def spartan_prove(shape: R1CSShape, wc: VectorCommitter, ec: VectorCommitter,
                  U: RelaxedInstance, Wit: RelaxedWitness) -> SpartanProof:
    f = shape.f
    cv = wc.cv
    p = f.p
    with span("Prover", "spartan.sumcheck1"):
        t = Transcript(b"spartan")
        _absorb_instance(t, shape, U, cv)

        ell_m = ec.n_vars
        m = 1 << ell_m
        z = shape.z_vector(Wit.W, U.u, U.x)

        from ..ops.native_fieldvec import PackedVec

        def _pad(vec, n):
            if isinstance(vec, PackedVec):
                return vec.pad_to(n)
            return list(vec) + [0] * (n - len(vec))

        az, bz, cz = shape.matvecs(z)
        az = _pad(az, m)
        bz = _pad(bz, m)
        cz = _pad(cz, m)
        e = _pad(Wit.E, m)

        tau = [t.challenge(b"tau_%d" % j, p) for j in range(ell_m)]

        from ..ops import native_fieldvec as FV
        native = FV.available()

        # ---- sumcheck 1 (degree 3 per round) ------------------------------
        sc1 = []
        rx: List[int] = []
        claim = 0
        u = U.u
        if native:
            eq_t = FV.eq_evals_mont(tau, p)
            taz, tbz, tcz, te = (FV.MontTable(v, p) for v in (az, bz, cz, e))
            for rnd in range(ell_m):
                evals = FV.sc1_evals(eq_t, taz, tbz, tcz, te, u, p)
                assert (evals[0] + evals[1]) % p == claim % p
                t.append(b"sc1", evals)
                r = t.challenge(b"sc1_r", p)
                rx.append(r)
                claim = _lagrange(evals, r, p)
                sc1.append(evals[:1] + evals[2:])      # g(1) = claim - g(0)
                for tab in (eq_t, taz, tbz, tcz, te):
                    tab.fold(r)
            vA, vB, vC, vE = (tab.first() for tab in (taz, tbz, tcz, te))
        else:
            eq_t = eq_evals(f, tau)
            for rnd in range(ell_m):
                half = len(az) // 2
                evals = []
                for tv in range(4):
                    s = 0
                    for b in range(half):
                        eqv = _eval_at(eq_t, b, half, tv, p)
                        av = _eval_at(az, b, half, tv, p)
                        bv = _eval_at(bz, b, half, tv, p)
                        cvv = _eval_at(cz, b, half, tv, p)
                        ev = _eval_at(e, b, half, tv, p)
                        s += eqv * ((av * bv - u * cvv - ev) % p)
                    evals.append(s % p)
                assert (evals[0] + evals[1]) % p == claim % p
                t.append(b"sc1", evals)
                r = t.challenge(b"sc1_r", p)
                rx.append(r)
                claim = _lagrange(evals, r, p)
                sc1.append(evals[:1] + evals[2:])
                eq_t = _fold_table(eq_t, r, p)
                az = _fold_table(az, r, p)
                bz = _fold_table(bz, r, p)
                cz = _fold_table(cz, r, p)
                e = _fold_table(e, r, p)
            vA, vB, vC, vE = az[0], bz[0], cz[0], e[0]
        t.append(b"claims", [vA, vB, vC, vE])
        G_s = shared_scalar_gens(cv).G[0]

    with span("Prover", "spartan.sumcheck2"):
        # ---- sumcheck 2 ---------------------------------------------------
        rr = t.challenge(b"rr", p)
        ell_z = wc.n_vars + 1
        nz = 1 << ell_z
        claim2 = (vA + rr * vB + rr * rr % p * vC) % p
        sc2 = []
        ry: List[int] = []
        if native:
            mats = FV.shape_mats(shape)
            eq_rx_m = FV.eq_evals_mont(rx, p)
            mtab_m = FV.MontTable([0] * nz, p)
            for coeff, mat in ((1, mats[0]), (rr, mats[1]),
                               (rr * rr % p, mats[2])):
                mat.mtab_accum(mtab_m.buf, eq_rx_m.buf, coeff)
            ztab_m = FV.MontTable(_pad(z, nz), p)
            for rnd in range(ell_z):
                evals = FV.sc2_evals(mtab_m, ztab_m, p)
                assert (evals[0] + evals[1]) % p == claim2 % p
                t.append(b"sc2", evals)
                r = t.challenge(b"sc2_r", p)
                ry.append(r)
                claim2 = _lagrange(evals, r, p)
                sc2.append(evals[:1] + evals[2:])
                mtab_m.fold(r)
                ztab_m.fold(r)
        else:
            eq_rx = eq_evals(f, rx)
            mtab = [0] * nz
            for coeff, M in ((1, shape.A), (rr, shape.B),
                             (rr * rr % p, shape.C)):
                for (i, j, v) in M:
                    mtab[j] = (mtab[j] + coeff * v % p * eq_rx[i]) % p
            ztab = z + [0] * (nz - len(z))
            for rnd in range(ell_z):
                half = len(ztab) // 2
                evals = []
                for tv in range(3):
                    s = 0
                    for b in range(half):
                        s += (_eval_at(mtab, b, half, tv, p)
                              * _eval_at(ztab, b, half, tv, p))
                    evals.append(s % p)
                assert (evals[0] + evals[1]) % p == claim2 % p
                t.append(b"sc2", evals)
                r = t.challenge(b"sc2_r", p)
                ry.append(r)
                claim2 = _lagrange(evals, r, p)
                sc2.append(evals[:1] + evals[2:])
                mtab = _fold_table(mtab, r, p)
                ztab = _fold_table(ztab, r, p)

        # W eval at ry[1:]
        w_pad = _pad(Wit.W, wc.n)
        if native:
            vW = FV.dot(w_pad, FV.eq_evals_native(ry[1:], p), p)
        else:
            from .sumcheck import verifier_mle_eval
            vW = verifier_mle_eval(f, w_pad, ry[1:])
        t.append(b"vW", vW)

    with span("Prover", "spartan.open"):
        # ---- batched opening ----------------------------------------------
        # The E claim (at rx, over ec's 2^ell_m-slot table) and the W claim
        # (at ry[1:], over wc's 2^(ell_z-1)-slot table) reduce to ONE opening:
        # a degree-2 sumcheck over g(b) = eqE(b)*E(b) + gamma*eqW(b)*W(b)
        # moves both claims to a common random point rho, where the two
        # polynomials combine homomorphically (shared basis, VectorCommitter)
        # into E + delta*W — one IPA instead of two.  This is the nova fork's
        # ipa_pc batched-evaluation shape; it halves the compress-stage MSM
        # work (the prover's hottest host loop).
        gamma = t.challenge(b"gamma", p)
        n_max = max(ec.n, wc.n)
        ell_max = logmn(n_max)
        e_full = _pad(Wit.E, n_max)
        w_full = _pad(Wit.W, n_max)
        # zero-padding points in FRONT of the eval point selects the original
        # table inside the 2^ell_max-slot zero-extension (eq_evals is
        # MSB-first: high zero bits pin the extra coordinates to 0)
        rx_pad = [0] * (ell_max - ell_m) + rx
        ry_pad = [0] * (ell_max - (ell_z - 1)) + ry[1:]
        claim3 = (vE + gamma * vW) % p
        sc3 = []
        rho: List[int] = []
        if native:
            eqE_m = FV.eq_evals_mont(rx_pad, p)
            eqW_m = FV.eq_evals_mont(ry_pad, p)
            e_m = FV.MontTable(e_full, p)
            w_m = FV.MontTable(w_full, p)
            for rnd in range(ell_max):
                ev_e = FV.sc2_evals(eqE_m, e_m, p)
                ev_w = FV.sc2_evals(eqW_m, w_m, p)
                evals = [(a + gamma * b) % p for a, b in zip(ev_e, ev_w)]
                assert (evals[0] + evals[1]) % p == claim3 % p
                t.append(b"sc3", evals)
                r = t.challenge(b"sc3_r", p)
                rho.append(r)
                claim3 = _lagrange(evals, r, p)
                sc3.append(evals[:1] + evals[2:])
                for tab in (eqE_m, e_m, eqW_m, w_m):
                    tab.fold(r)
            vE2, vW2 = e_m.first(), w_m.first()
        else:
            eqE = eq_evals(f, rx_pad)
            eqW = eq_evals(f, ry_pad)
            et, wt = list(e_full), list(w_full)
            for rnd in range(ell_max):
                half = len(et) // 2
                evals = []
                for tv in range(3):
                    s = 0
                    for b in range(half):
                        s += (_eval_at(eqE, b, half, tv, p)
                              * _eval_at(et, b, half, tv, p)
                              + gamma * _eval_at(eqW, b, half, tv, p)
                              * _eval_at(wt, b, half, tv, p))
                    evals.append(s % p)
                assert (evals[0] + evals[1]) % p == claim3 % p
                t.append(b"sc3", evals)
                r = t.challenge(b"sc3_r", p)
                rho.append(r)
                claim3 = _lagrange(evals, r, p)
                sc3.append(evals[:1] + evals[2:])
                eqE = _fold_table(eqE, r, p)
                eqW = _fold_table(eqW, r, p)
                et = _fold_table(et, r, p)
                wt = _fold_table(wt, r, p)
            vE2, vW2 = et[0], wt[0]
        t.append(b"vv", [vE2, vW2])
        delta = t.challenge(b"delta", p)

        if native:
            comb = FV.fold_vec(e_full, w_full, delta, p)
        else:
            comb = [(a + delta * b) % p for a, b in zip(e_full, w_full)]
        blind_c = (Wit.E_blind + delta * Wit.W_blind) % p
        C_comb = cv.add(U.comm_E, cv.mul(delta, U.comm_W))
        v_comb = (vE2 + delta * vW2) % p
        C_v3 = shared_scalar_gens(cv).commit([v_comb], 0)
        big = wc if wc.n >= ec.n else ec
        eval_p = ipa_prove(big.gens, G_s, comb, blind_c, eq_evals(f, rho),
                           v_comb, 0, C_comb, C_v3,
                           Transcript(b"spartan_batch"))

    return SpartanProof(sc1, vA, vB, vC, vE, sc2, vW, sc3, vE2, vW2,
                        eval_p)


def spartan_verify(shape: R1CSShape, wc: VectorCommitter,
                   ec: VectorCommitter, U: RelaxedInstance,
                   proof: SpartanProof) -> bool:
    f = shape.f
    cv = wc.cv
    p = f.p
    t = Transcript(b"spartan")
    _absorb_instance(t, shape, U, cv)

    ell_m = ec.n_vars
    tau = [t.challenge(b"tau_%d" % j, p) for j in range(ell_m)]

    # proof rounds are COMPRESSED: g(1) is omitted and re-derived as
    # claim - g(0) (so g(0)+g(1)=claim holds by construction); the full
    # evaluation list is what the transcript absorbs.
    claim = 0
    rx: List[int] = []
    for comp in proof.sc1:
        if len(comp) != 3:
            return False
        evals = [comp[0], (claim - comp[0]) % p, comp[1], comp[2]]
        t.append(b"sc1", evals)
        r = t.challenge(b"sc1_r", p)
        rx.append(r)
        claim = _lagrange(evals, r, p)
    if len(rx) != ell_m:
        return False

    # eq(tau, rx)
    eq_tau_rx = 1
    for tj, rj in zip(tau, rx):
        eq_tau_rx = eq_tau_rx * ((tj * rj + (1 - tj) * (1 - rj)) % p) % p
    vA, vB, vC, vE = proof.vA, proof.vB, proof.vC, proof.vE
    if claim != eq_tau_rx * ((vA * vB - U.u * vC - vE) % p) % p:
        return False
    t.append(b"claims", [vA, vB, vC, vE])
    G_s = shared_scalar_gens(cv).G[0]

    rr = t.challenge(b"rr", p)
    claim2 = (vA + rr * vB + rr * rr % p * vC) % p
    ell_z = wc.n_vars + 1
    ry: List[int] = []
    for comp in proof.sc2:
        if len(comp) != 2:
            return False
        evals = [comp[0], (claim2 - comp[0]) % p, comp[1]]
        t.append(b"sc2", evals)
        r = t.challenge(b"sc2_r", p)
        ry.append(r)
        claim2 = _lagrange(evals, r, p)
    if len(ry) != ell_z:
        return False

    # sparse matrix evals at (rx, ry) -- verifier-side O(nnz)
    from ..ops import native_fieldvec as FV
    if FV.available():
        mats = FV.shape_mats(shape)
        eq_rx_m = FV.eq_evals_mont(rx, p)
        eq_ry_m = FV.eq_evals_mont(ry, p)
        vM = 0
        for coeff, mat in ((1, mats[0]), (rr, mats[1]),
                           (rr * rr % p, mats[2])):
            vM = (vM + coeff * FV.bilinear(mat, eq_rx_m, eq_ry_m)) % p
    else:
        eq_rx = eq_evals(f, rx)
        eq_ry = eq_evals(f, ry)
        vM = 0
        for coeff, M in ((1, shape.A), (rr, shape.B),
                         (rr * rr % p, shape.C)):
            for (i, j, v) in M:
                vM = (vM + coeff * v % p * eq_rx[i] % p * eq_ry[j]) % p

    # public half of z
    pub = [U.u % p] + [x % p for x in U.x]
    pub += [0] * (wc.n - len(pub))
    eq_ry_rest = eq_evals(f, ry[1:])
    vP = sum(a * b % p for a, b in zip(pub, eq_ry_rest)) % p
    vz = ((1 - ry[0]) * proof.vW + ry[0] * vP) % p
    if claim2 != vM * vz % p:
        return False

    t.append(b"vW", proof.vW)

    # ---- batched opening ----------------------------------------------
    gamma = t.challenge(b"gamma", p)
    n_max = max(ec.n, wc.n)
    ell_max = logmn(n_max)
    claim3 = (proof.vE + gamma * proof.vW) % p
    rho: List[int] = []
    for comp in proof.sc3:
        if len(comp) != 2:
            return False
        evals = [comp[0], (claim3 - comp[0]) % p, comp[1]]
        t.append(b"sc3", evals)
        r = t.challenge(b"sc3_r", p)
        rho.append(r)
        claim3 = _lagrange(evals, r, p)
    if len(rho) != ell_max:
        return False

    rx_pad = [0] * (ell_max - ell_m) + rx
    ry_pad = [0] * (ell_max - (ell_z - 1)) + ry[1:]
    eqE_f = 1
    eqW_f = 1
    for a, b in zip(rx_pad, rho):
        eqE_f = eqE_f * ((a * b + (1 - a) * (1 - b)) % p) % p
    for a, b in zip(ry_pad, rho):
        eqW_f = eqW_f * ((a * b + (1 - a) * (1 - b)) % p) % p
    if claim3 != (eqE_f * proof.vE2 + gamma * eqW_f * proof.vW2) % p:
        return False
    t.append(b"vv", [proof.vE2, proof.vW2])
    delta = t.challenge(b"delta", p)

    C_comb = cv.add(U.comm_E, cv.mul(delta, U.comm_W))
    v_comb = (proof.vE2 + delta * proof.vW2) % p
    C_v3 = shared_scalar_gens(cv).commit([v_comb], 0)
    big = wc if wc.n >= ec.n else ec
    return ipa_verify(big.gens, G_s, eq_evals(f, rho), C_comb, C_v3,
                      proof.eval, Transcript(b"spartan_batch"))
