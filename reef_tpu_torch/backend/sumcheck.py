"""nlookup sumcheck: MLE folds, eq tables, partial evals + Fiat-Shamir.

Host reference implementation in python ints (the oracle the circuit gadget
and the device kernel must agree with) mirroring the reference's
r1cs_helper.rs:441-634:

  - `linear_mle_product`: one sumcheck round over the product of two
    multilinear tables (T and eq), producing the degree-2 coefficients
    (xsq, x, const) and folding both tables by the squeezed challenge.
    Rounds split on the TOP index bit (MSB-first), matching the q-bit /
    running-q conventions everywhere else.
  - `gen_eq_table`: eq_t[j] = sum_{i: q_i == j} r^{i+1}
                            + r^{m+1} * ~eq(bits(j), running_q).
  - `prover_mle_partial_eval` / `verifier_mle_eval`: MLE evaluation with an
    optional "hole" coordinate.

The Fiat-Shamir transcript runs over the SAFE Poseidon sponge
(ops.poseidon.HostSponge); absorb orders follow r1cs.rs:2260-2340:
  init: [doc_hash?] ++ combined_qs ++ v_1..v_m ++ running_q ++ running_v,
  squeeze claim_r; per round: absorb [g_const, g_x, g_xsq], squeeze r_i.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ..ops import field as F
from ..ops.poseidon import HostSponge, IOPattern
from .costs import NL_RATE, logmn


def linear_mle_product(f: F.HostField, table_t: List[int], table_eq: List[int],
                       ell: int, i: int, sponge: HostSponge
                       ) -> Tuple[int, int, int, int]:
    """One sumcheck round (round i, 1-indexed): returns (r_i, xsq, x, const)
    and folds both tables in place by r_i (top-bit split)."""
    p = f.p
    pow_ = 1 << (ell - i)
    assert len(table_t) == 2 * pow_ and len(table_eq) == 2 * pow_

    xsq = x = con = 0
    for b in range(pow_):
        t0, t1 = table_t[b], table_t[b + pow_]
        e0, e1 = table_eq[b], table_eq[b + pow_]
        ts = t1 - t0
        es = e1 - e0
        xsq += ts * es
        x += es * t0 + ts * e0
        con += t0 * e0
    xsq, x, con = xsq % p, x % p, con % p

    sponge.absorb([con, x, xsq])
    r_i = sponge.squeeze(1)[0]

    for b in range(pow_):
        table_t[b] = (table_t[b] * (1 - r_i) + table_t[b + pow_] * r_i) % p
        table_eq[b] = (table_eq[b] * (1 - r_i) + table_eq[b + pow_] * r_i) % p
    del table_t[pow_:]
    del table_eq[pow_:]
    # keep table length invariant for callers that index 2^ell: we truncate;
    # callers track the shrinking length via the round number.
    return r_i, xsq, x, con


def gen_eq_table(f: F.HostField, rs: List[int], qs: List[int],
                 last_q: List[int]) -> List[int]:
    """Build the eq table: claims at the lookup points + the running claim.

    rs = [r^1..r^{m+1}]; last_q is the running q MSB-first (last_q[0] pairs
    with the top index bit)."""
    p = f.p
    ell = len(last_q)
    t_len = 1 << ell
    assert len(rs) == len(qs) + 1
    eq_t = [0] * t_len
    for i, qi in enumerate(qs):
        eq_t[qi] = (eq_t[qi] + rs[i]) % p
    for idx in range(t_len):
        term = rs[len(qs)]
        for j in range(ell):  # j over bit positions, MSB-first pairing
            xi = (idx >> (ell - 1 - j)) & 1
            lq = last_q[j]
            term = term * ((xi * lq + (1 - xi) * (1 - lq)) % p) % p
        eq_t[idx] = (eq_t[idx] + term) % p
    return eq_t


def prover_mle_partial_eval(f: F.HostField, prods: List[int], x: List[int],
                            es: List[int], for_t: bool,
                            last_q: Optional[List[int]] = None
                            ) -> Tuple[int, int]:
    """MLE partial evaluation with an optional hole (x_j == -1).

    Mirrors r1cs_helper.rs:551-634: returns (hole_coeff, const_part); with no
    hole, const_part is the full evaluation.  x is MSB-first: x[0] pairs with
    the top bit of each index in es."""
    p = f.p
    m = len(x)
    if for_t:
        assert (1 << (m - 1)) <= len(prods) <= (1 << m)
        assert len(es) == len(prods)
    elif last_q is not None:
        assert len(es) + 1 == len(prods)

    hole_coeff = 0
    minus_coeff = 0
    for i in range(len(es) + 1):
        if i < len(es):
            prod = prods[i]
            next_hole = 0
            for j in reversed(range(m)):
                ej = (es[i] >> j) & 1
                xv = x[m - j - 1]
                if xv == -1:
                    next_hole = ej
                else:
                    prod = prod * ((xv if ej == 1 else (1 - xv)) % p) % p
            if next_hole == 1:
                hole_coeff = (hole_coeff + prod) % p
            else:
                minus_coeff = (minus_coeff + prod) % p
        elif last_q is not None:
            prod = prods[i]
            nh, nm = 1, 1
            for j in range(m):
                ej = last_q[j]
                xv = x[j]
                if xv == -1:
                    nh, nm = ej, (1 - ej) % p
                else:
                    prod = prod * ((ej * xv + (1 - ej) * (1 - xv)) % p) % p
            hole_coeff = (hole_coeff + prod * nh) % p
            minus_coeff = (minus_coeff + prod * nm) % p
    hole_coeff = (hole_coeff - minus_coeff) % p
    return hole_coeff, minus_coeff


def verifier_mle_eval(f: F.HostField, table: List[int], q: List[int]) -> int:
    """Full MLE evaluation of the table at point q (MSB-first)."""
    if len(table) >= 64:
        from ..ops import native_fieldvec as FV
        if FV.available() and f.p in FV.FIELD_ID:
            eq = FV.eq_evals_native(q, f.p)
            return FV.dot(table, eq[:len(table)], f.p)
    _, con = prover_mle_partial_eval(f, table, q, list(range(len(table))),
                                     True, None)
    return con


# ---------------------------------------------------------------------------
# full nlookup prover (host): FS transcript + all rounds
# ---------------------------------------------------------------------------

def combine_qs(qs: List[int], sc_l: int, num_vs: int) -> List[int]:
    """Pack lookup-index bits into <=254-bit field elements for absorption.

    Bit order mirrors r1cs.rs:2210-2245: per lookup i, bits MSB-first,
    LSB-first slot packing; chunk-boundary bits and the very last bit are
    dropped (both sides of the protocol agree on this)."""
    num_cqs = math.ceil(num_vs * sc_l / 254.0)
    out = []
    cq = 0
    combined = 0
    slot = 1
    for i in range(num_vs):
        bits_msb = [(qs[i] >> (sc_l - 1 - j)) & 1 for j in range(sc_l)]
        for j, bit in enumerate(bits_msb):
            if (i * sc_l) + j >= 254 * (cq + 1) or (i == num_vs - 1
                                                    and j == sc_l - 1):
                cq += 1
                out.append(combined)
                combined = 0
                slot = 1
            else:
                combined += bit * slot
                slot *= 2
    assert len(out) == num_cqs
    return out


def nlookup_pattern(num_vs: int, sc_l: int, num_cqs: int, with_doc: bool,
                    tag: str) -> IOPattern:
    n = num_vs + sc_l + 1 + num_cqs + (1 if with_doc else 0)
    ops = [("absorb", n), ("squeeze", 1)]
    for _ in range(sc_l):
        ops += [("absorb", 3), ("squeeze", 1)]
    return IOPattern(ops, domain=tag.encode())


class NlookupProof:
    """All per-batch nlookup witness values (fed into the step circuit)."""

    __slots__ = ("claim_r", "sc_rs", "g_coeffs", "last_claim",
                 "next_running_q", "next_running_v", "combined_qs")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    def __eq__(self, other):
        if not isinstance(other, NlookupProof):
            return NotImplemented
        return all(getattr(self, k) == getattr(other, k)
                   for k in self.__slots__)

    __hash__ = None


def nlookup_prove(f: F.HostField, table: List[int], qs: List[int],
                  vs: List[int], running_q: Optional[List[int]],
                  running_v: Optional[int], tag: str,
                  doc_hash: Optional[int] = None,
                  host_cache=None) -> NlookupProof:
    """Run the prover side of one nlookup batch (r1cs.rs:2177-2393) on the
    host.  (The device round loop is not part of this package yet.)"""
    p = f.p
    sc_l = logmn(len(table))
    num_vs = len(vs)
    assert num_vs == len(qs)

    prev_q = running_q if running_q is not None else [0] * sc_l
    prev_v = running_v if running_v is not None else table[0] % p

    cqs = combine_qs(qs, sc_l, num_vs)
    io = nlookup_pattern(num_vs, sc_l, len(cqs), doc_hash is not None, tag)
    sponge = HostSponge(f, io, rate=NL_RATE)

    query = ([] if doc_hash is None else [doc_hash % p])
    query += [c % p for c in cqs]
    query += [v % p for v in vs]
    query += [q % p for q in prev_q]
    query.append(prev_v % p)
    sponge.absorb(query)
    claim_r = sponge.squeeze(1)[0]

    rs = [claim_r]
    for _ in range(num_vs):
        rs.append(rs[-1] * claim_r % p)

    # native host path: eq-table build + per-round coefficient sums + folds
    # in C (the round-1 python loops dominated prove time on large docs);
    # the Fiat-Shamir sponge stays on the host between rounds.  The whole
    # prep stays in the Montgomery domain: eq built natively, scaled by the
    # running-claim challenge in place, the few lookup deltas patched per
    # index; the (constant) table reuses a caller-provided cached
    # MontTable via an O(n) memcpy instead of an O(n) int conversion.
    from ..ops import native_fieldvec as FV
    if FV.available() and p in FV.FIELD_ID and len(table) >= 32:
        e_m = FV.eq_evals_mont(prev_q, p)
        r_run = rs[num_vs]
        e_m.scale(r_run)
        for i, qi in enumerate(qs):
            e_m.add_at(qi, rs[i])
        if host_cache is not None and host_cache.n == (1 << sc_l):
            t_m = host_cache.copy()
        else:
            sct = [t % p for t in table]
            sct.extend([0] * ((1 << sc_l) - len(sct)))
            t_m = FV.MontTable(sct, p)
        sc_rs = []
        g_coeffs = []
        for _ in range(sc_l):
            g_xsq, g_x, g_const = FV.nl_round(t_m, e_m, p)
            sponge.absorb([g_const, g_x, g_xsq])
            r_i = sponge.squeeze(1)[0]
            g_coeffs.append((g_xsq, g_x, g_const))
            sc_rs.append(r_i)
            t_m.fold(r_i)
            e_m.fold(r_i)
        last_claim = (g_xsq * sc_rs[-1] % p * sc_rs[-1] + g_x * sc_rs[-1]
                      + g_const) % p
        return NlookupProof(claim_r=claim_r, sc_rs=sc_rs,
                            g_coeffs=g_coeffs, last_claim=last_claim,
                            next_running_q=list(sc_rs),
                            next_running_v=t_m.first(), combined_qs=cqs)

    eq_table = gen_eq_table(f, rs, qs, prev_q)
    # pad sc table to the power of two (doc tables may be shorter)
    sct = [t % p for t in table]
    sct.extend([0] * ((1 << sc_l) - len(sct)))

    sc_rs: List[int] = []
    g_coeffs: List[Tuple[int, int, int]] = []  # (xsq, x, const) per round
    g_xsq = g_x = g_const = 0
    for i in range(1, sc_l + 1):
        r_i, g_xsq, g_x, g_const = linear_mle_product(
            f, sct, eq_table, sc_l, i, sponge)
        g_coeffs.append((g_xsq, g_x, g_const))
        sc_rs.append(r_i)

    last_claim = (g_xsq * sc_rs[-1] % p * sc_rs[-1] + g_x * sc_rs[-1]
                  + g_const) % p

    _, next_running_v = prover_mle_partial_eval(
        f, table, sc_rs, list(range(len(table))), True, None)

    return NlookupProof(claim_r=claim_r, sc_rs=sc_rs, g_coeffs=g_coeffs,
                        last_claim=last_claim, next_running_q=list(sc_rs),
                        next_running_v=next_running_v, combined_qs=cqs)


def nlookup_verify_claim(f: F.HostField, proof: NlookupProof, qs: List[int],
                         vs: List[int], prev_q: List[int], prev_v: int
                         ) -> bool:
    """Re-check the sumcheck chain host-side (used by tests; the real check
    is the in-circuit gadget)."""
    p = f.p
    claim_r = proof.claim_r
    # lhs Horner
    claim = 0
    coeffs = [0] + list(vs) + [prev_v]
    for c in reversed(coeffs[1:]):
        claim = (claim + c) * claim_r % p
    for i, (xsq, x, con) in enumerate(proof.g_coeffs):
        if (claim - (xsq + x + 2 * con)) % p != 0:
            return False
        r = proof.sc_rs[i]
        claim = (con + r * (x + r * xsq)) % p
    if (claim - proof.last_claim) % p != 0:
        return False
    # eq-eval domino
    eq_evals = []
    for i in range(len(qs)):
        prod = 1
        for j in range(len(proof.sc_rs)):
            bit = (qs[i] >> (len(proof.sc_rs) - 1 - j)) & 1
            rj = proof.sc_rs[j]
            prod = prod * ((bit * rj + (1 - bit) * (1 - rj)) % p) % p
        eq_evals.append(prod)
    prod = 1
    for j in range(len(proof.sc_rs)):
        qj = prev_q[j]
        rj = proof.sc_rs[j]
        prod = prod * ((qj * rj + (1 - qj) * (1 - rj)) % p) % p
    eq_evals.append(prod)
    eq_eval = 0
    for c in reversed(eq_evals):
        eq_eval = (eq_eval + c) * claim_r % p
    return (proof.last_claim - eq_eval * proof.next_running_v) % p == 0
