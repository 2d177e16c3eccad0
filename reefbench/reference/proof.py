"""Plain checks that tie a proof to its statement: the document the
benchmark made, under the commitment the check has worked out again.

A proof carries, besides the folds and SNARKs that prove the automaton's
run over the document, a claim about the committed document: a point q
(its `running_q`) and a hiding hash d = Poseidon(v, salt) of the value v
that the circuit's lookups give the document's multilinear extension
there; d and q are outputs of the circuit (entries of the IVC proof's
`zn`), and an opening proves that the committed rows give v at q.  Here:

- `claim`: v is worked out from the document itself (`mle`), d from v
  and the commitment's salt (`poseidon.hide`), and both d and q have to
  be the proof's and the circuit's (q whole and in order in `zn`; under
  projections `-p` after a prefix of chunk bits);
- `opening`: the Hyrax opening, a log-round inner-product argument over
  a SHA-256 transcript, verified against the commitment's rows.

Under `-y` (hybrid) the circuit's lookups read one table of 2^(k+1)
entries, the automaton's table and the document side by side, and its
claim is v = (1 - q0) t + q0 v', with t the automaton table's extension
at q[1:] and v' the document's at the remaining point (`running_q`).
The proof commits to v' apart (C_v'), opens the rows against C_v', and
proves with a Schnorr proof that C_v and C_l commit to one value, C_l =
q0 C_v' + (1 - q0) t G_s.  Here, besides the point as above:

- `claim not the circuit's`: d is an entry of `zn`;
- `claim not the document's`: the opening's last value is the
  document's, folded by the opening's own rounds: a_final = sum_i s'_i
  w_i, w the rows of the document combined by the eq table of the
  point's first half, s'_i the product over rounds of x_k where bit k of
  i (the first round the highest bit) is 0 and 1 / x_k where it is 1;
- `opening`: the Hyrax opening against C_v';
- `split`: the Schnorr proof between C_v and C_l (every proof).

What stays with the port's verifier under `-y`: t, which needs the
automaton built from the regex, and with it C_l's t G_s term and d's
preimage v.

The run itself, and the folds and SNARKs that prove it, stay hidden in
the proof (zero knowledge); whether the document matches is `re`'s to
say (`verdict`), and the proof's acceptance the port's verifier's.
Merkle proofs (`-m`) have no plain check yet.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

from . import curve, poseidon

Q = curve.Q
LIMB = 16
# what a malformed proof raises inside a check: the check fails
_MALFORMED = (ValueError, AttributeError, TypeError, OverflowError)


class Transcript:
    """The SHA-256 Fiat-Shamir transcript of the commitment's proofs:
    SHA-256 from b"reef_tpu/" + label; an append writes its label's
    2-byte length and the label, then an integer as 32 bytes big endian,
    a list item by item as appends with an empty label, or raw bytes; a
    challenge writes b"challenge/" + label, reads the digest mod the
    order, then writes b"next"."""

    def __init__(self, label: bytes):
        self.h = hashlib.sha256(b"reef_tpu/" + label)

    def append(self, label: bytes, data) -> None:
        self.h.update(len(label).to_bytes(2, "big") + label)
        if isinstance(data, int):
            self.h.update(data.to_bytes(32, "big"))
        elif isinstance(data, (list, tuple)):
            for d in data:
                self.append(b"", d)
        else:
            self.h.update(data)

    def append_point(self, label: bytes, pt: curve.Point) -> None:
        self.append(label, list(curve.compress(pt)))

    def challenge(self, label: bytes) -> int:
        self.h.update(b"challenge/" + label)
        out = int.from_bytes(self.h.digest(), "big") % Q
        self.h.update(b"next")
        return out


def eq(point: Sequence[int]) -> List[int]:
    """eq(point, bits(j)) for every j, the point's first entry the
    highest bit of j."""
    out = [1]
    for q in point:
        out = [x for v in out for x in (v * (1 - q) % Q, v * q % Q)]
    return out


def combined_rows(u: np.ndarray, left: int, L: Sequence[int]) -> List[int]:
    """w_c = sum_j L_j u[j * cols + c] mod Q: the rows of u, as a matrix
    of 2^left rows, combined by L.  The column sums run in int64 on
    16-bit limbs of L."""
    m = u.reshape(1 << left, -1)
    if int(m.max()) * m.shape[0] << LIMB >= 1 << 62:
        raise ValueError("document codes too large for the limb sums")
    limbs = np.array([[(x >> (LIMB * i)) & ((1 << LIMB) - 1)
                       for i in range(-(-Q.bit_length() // LIMB))]
                      for x in L], dtype=np.int64)
    return [sum(int(s) << (LIMB * i) for i, s in enumerate(col)) % Q
            for col in m.T @ limbs]


def mle(u: np.ndarray, point: Sequence[int]) -> int:
    """The multilinear extension of the vector u (2^k entries) at the
    point, rows first: sum_j L_j sum_c R_c u[j * cols + c], with L and R
    the eq tables of the point's first k // 2 and last entries."""
    left = len(point) // 2
    w = combined_rows(u, left, eq(point[:left]))
    return sum(wc * r for wc, r in zip(w, eq(point[left:]))) % Q


def challenges(rows: Sequence[curve.Point], q: Sequence[int], left: int,
               v_commit: curve.Point, ipa):
    """The Hyrax opening's transcript at q against v_commit, drawn as
    prover and verifier draw it: (R, C_w, tau, [x_k]), with L and R the
    eq tables of q's first `left` entries and of the rest and C_w = sum_j
    L_j Row_j; None where the proof has not one round a halving of R."""
    L, R = eq([x % Q for x in q[:left]]), eq([x % Q for x in q[left:]])
    n = len(R)
    if len(ipa.Ls) != n.bit_length() - 1 or len(ipa.Rs) != len(ipa.Ls):
        return None
    t = Transcript(b"dot_prod_proof")
    for pt in rows:
        t.append_point(b"row", pt)
    t.append(b"q", list(q))
    c_w = curve.to_affine(curve.msm(L, rows))
    t.append_point(b"C_w", c_w)
    t.append_point(b"C_v", v_commit)
    t.append(b"R", b"".join(r.to_bytes(32, "little") for r in R))
    tau = t.challenge(b"ipa_tau")
    xs = []
    for lc, rc in zip(ipa.Ls, ipa.Rs):
        t.append(b"L", list(lc))
        t.append(b"R", list(rc))
        xs.append(t.challenge(b"ipa_x"))
    return R, c_w, tau, xs


def _folds(xs: Sequence[int], low_first: bool) -> List[int]:
    """Each index's product over the rounds of x_k or 1 / x_k by its bit
    of round k, the first round the highest bit: x_k on a 0 bit when
    `low_first`, on a 1 bit otherwise."""
    s = [1]
    for x in xs:
        xi = pow(x, -1, Q)
        pair = (x, xi) if low_first else (xi, x)
        s = [v * m % Q for v in s for m in pair]
    return s


def opening_ok(rows: Sequence[curve.Point], q: Sequence[int], left: int,
               v_commit: curve.Point, ipa, drawn=None) -> bool:
    """The Hyrax opening of the rows at q against v_commit = v G_s + r H:
    with C_w, tau and the rounds' x_k from the transcript (`challenges`,
    or `drawn` where they are drawn already), s the folded basis'
    coefficients (x_k or 1 / x_k by each bit of i, the first round the
    highest bit), it holds when
      C_w + tau C_v + sum x_k^2 L_k + sum x_k^-2 R_k
      - a sum_i s_i G_i - tau a <s, R> G_s - rho H
    is the identity (G the generators of b"doc/vec", G_s that of
    b"reef/scalar", H of b"reef/blind")."""
    if drawn is None:
        drawn = challenges(rows, q, left, v_commit, ipa)
    if drawn is None:
        return False
    R, c_w, tau, xs = drawn
    if not all(xs):
        return False
    xis = [pow(x, -1, Q) for x in xs]
    s = _folds(xs, low_first=False)
    a = ipa.a_final % Q
    r_final = sum(si * ri for si, ri in zip(s, R)) % Q
    scalars = ([tau] + [x * x % Q for x in xs] + [xi * xi % Q for xi in xis]
               + [-a * si for si in s] + [-tau * a * r_final, -ipa.rho_final])
    points = ([v_commit] + [curve.decompress(p) for p in ipa.Ls]
              + [curve.decompress(p) for p in ipa.Rs]
              + list(curve.generators(b"doc/vec", len(R)))
              + [curve.generators(b"reef/scalar", 1)[0],
                 curve.hash_to_curve(b"reef/blind")])
    acc = curve.add(curve.to_jac(c_w), curve.msm(scalars, points))
    return curve.to_affine(acc) is None


def folded_document(u: np.ndarray, q: Sequence[int], left: int,
                    xs: Sequence[int]) -> int:
    """The opening's last value for the document u at q under the rounds'
    x_k: the rows combined by eq(q[:left]), w, folded as each round folds
    it, x w_lo + 1 / x w_hi; that is sum_i s'_i w_i."""
    w = combined_rows(u, left, eq([x % Q for x in q[:left]]))
    return sum(si * wi for si, wi in zip(_folds(xs, low_first=True), w)) % Q


def split_ok(c1: curve.Point, c2: curve.Point, eq_proof) -> bool:
    """The Schnorr proof that C1 and C2 commit to one value: z H = c (C1 -
    C2) + alpha, c drawn from the transcript b"eq_proof" after C1, C2 and
    alpha, H the generator of b"reef/blind"."""
    alpha = curve.decompress(eq_proof.alpha)
    t = Transcript(b"eq_proof")
    t.append_point(b"C1", c1)
    t.append_point(b"C2", c2)
    t.append_point(b"alpha", alpha)
    c = t.challenge(b"c")
    h = curve.hash_to_curve(b"reef/blind")
    lhs = curve.add(curve.mul(eq_proof.z, h), curve.mul(c, c2))
    rhs = curve.add(curve.mul(c, c1), curve.to_jac(alpha))
    return curve.to_affine(lhs) == curve.to_affine(rhs)


def _inside(part: Sequence[int], whole: Sequence[int]) -> bool:
    n = len(part)
    return n > 0 and any(list(whole[i:i + n]) == list(part)
                         for i in range(len(whole) - n + 1))


def mismatches(cmt, proof, u: np.ndarray, flags: Sequence[str],
               opening: bool = True) -> List[str]:
    """What in `proof` (a `.proof` artifact read by `artifact.loads`)
    disagrees with the document u (`commitment.udoc`) under `cmt`; empty
    when nothing does.  `opening` verifies the Hyrax opening as well."""
    if "-m" in flags:
        raise ValueError("no plain check of Merkle proofs")
    hybrid = "-y" in flags
    nl, cp = cmt.nldoc, proof.consist
    if cp is None:
        return ["no consistency proof"]
    if hybrid and None in (cp.v_prime_commit, cp.eq_proof, cp.l_commit):
        return ["no hybrid split"]
    zn = [z % Q for z in proof.ivc.zn]
    q = [x % Q for x in cp.running_q]
    if len(q) != nl.n_vars or len(u) != 1 << nl.n_vars:
        return [f"point of {len(q)} entries for 2^{nl.n_vars}"]
    off = []
    circuit_q = q
    if "-p" in flags:
        bits = next((i for i in range(len(q)) if _inside(q[i:], zn)),
                    len(q))
        if any(b not in (0, 1) for b in q[:bits]):
            off.append("projection prefix not bits")
        circuit_q = q[bits:]
    if not _inside(circuit_q, zn):
        off.append("point not the circuit's")
    if hybrid:
        return off + _hybrid_mismatches(nl, cp, zn, u, opening)
    d = poseidon.hide(mle(u, q), nl.hash_salt)
    if cp.hash_d % Q != d:
        off.append("claim not the document's")
    if d not in zn:
        off.append("claim not the circuit's")
    if opening:
        try:
            ok = opening_ok([tuple(p) for p in nl.commit.row_commits],
                            cp.running_q, nl.commit.l_left,
                            curve.decompress(cp.v_commit), cp.eval_proof)
        except _MALFORMED:
            ok = False
        if not ok:
            off.append("opening")
    return off


def _hybrid_mismatches(nl, cp, zn, u, opening: bool) -> List[str]:
    """The checks of a hybrid proof after the point's (module
    docstring): d in `zn`, the opening's last value against the
    document, the opening against C_v' (where `opening`), the split."""
    off = []
    if cp.hash_d % Q not in zn:
        off.append("claim not the circuit's")
    try:
        rows = [tuple(p) for p in nl.commit.row_commits]
        left, v_prime = nl.commit.l_left, curve.decompress(cp.v_prime_commit)
        drawn = challenges(rows, cp.running_q, left, v_prime, cp.eval_proof)
        held = drawn is not None and cp.eval_proof.a_final % Q == \
            folded_document(u, cp.running_q, left, drawn[3])
    except _MALFORMED:
        drawn, held = None, False
    if not held:
        off.append("claim not the document's")
    if opening:
        try:
            ok = drawn is not None and opening_ok(
                rows, cp.running_q, left, v_prime, cp.eval_proof, drawn)
        except _MALFORMED:
            ok = False
        if not ok:
            off.append("opening")
    try:
        ok = split_ok(curve.decompress(cp.v_commit),
                      curve.decompress(cp.l_commit), cp.eq_proof)
    except _MALFORMED:
        ok = False
    if not ok:
        off.append("split")
    return off
