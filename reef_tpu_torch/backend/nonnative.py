"""Non-native modular arithmetic gadgets for the IVC fold verifier.

Nova's augmented circuit on one curve of the cycle must fold the scalar part
(u, x) of instances living on the OTHER curve: arithmetic mod M inside a
circuit over a different prime p (the reference gets this from nova-snark's
BigNat gadgets, nova.rs via bellperson-nonnative).  Both pasta primes are
~2^254, and each does not fit (or its products do not fit) in the other
field, so values are carried as 3 limbs of 85 bits:

    v  =  l0 + l1*2^85 + l2*2^170,     0 <= l_i < 2^85  (range-checked)

The one operation the fold verifier needs is the fold step itself:

    a' = (a + r*b) mod M        r < 2^128 (the truncated fold challenge)

checked by witnessing the quotient k (a + r*b = a' + k*M over the integers,
k < 2^129) and two signed carries, with every per-limb constraint bounded
well below the native modulus so field equality implies integer equality.
a' is additionally constrained CANONICAL (a' < M) so folded instances hash
identically in-circuit and on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from .r1cs import LC, ConstraintSystem, lc_add, lc_const, lc_scale, lc_sub

LIMB_BITS = 85
N_LIMBS = 3
LIMB_MASK = (1 << LIMB_BITS) - 1
K_BITS = 130          # quotient bound: k <= 2^128 (r < 2^128, b < M)
C_BITS = 131          # signed carry bound (stored offset by 2^C_BITS)


def limbs_of(v: int) -> List[int]:
    """Host-side limb decomposition (LSB-first)."""
    assert 0 <= v < (1 << (LIMB_BITS * N_LIMBS))
    return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(N_LIMBS)]


def from_limbs(ls: Sequence[int]) -> int:
    return sum(l << (LIMB_BITS * i) for i, l in enumerate(ls))


class NNValue:
    """A non-native value as N_LIMBS limb LCs (caller-invariant: each limb
    is range-checked < 2^LIMB_BITS, and the value is < M)."""

    __slots__ = ("limbs",)

    def __init__(self, limbs: List[LC]):
        assert len(limbs) == N_LIMBS
        self.limbs = limbs

    @staticmethod
    def constant(v: int) -> "NNValue":
        return NNValue([lc_const(l) for l in limbs_of(v)])


def nn_input(cs: ConstraintSystem, name: str) -> NNValue:
    """Allocate a non-native value as range-checked limb inputs."""
    limbs = []
    for i in range(N_LIMBS):
        w = cs.input(f"{name}_l{i}")
        cs.bits(w, LIMB_BITS, f"{name}_l{i}r")
        limbs.append(w)
    return NNValue(limbs)


def nn_witness(name: str, v: int) -> Dict[str, int]:
    return {f"{name}_l{i}": l for i, l in enumerate(limbs_of(v))}


def nn_enforce_equal(cs: ConstraintSystem, a: NNValue, b: NNValue):
    for la, lb in zip(a.limbs, b.limbs):
        cs.enforce_eq(la, lb)


def nn_enforce_canonical(cs: ConstraintSystem, a: NNValue, M: int,
                         name: str):
    """Assert a < M given a's limbs are range-checked: witness
    d = (M-1) - a limb-wise with two borrow-free carry bits."""
    cs_f = cs.f.p
    m1 = limbs_of(M - 1)

    def a_val(z, limbs=a.limbs):
        return from_limbs([cs.eval_lc(l, z) for l in limbs])

    d_limbs = []
    for i in range(N_LIMBS):
        d = cs.aux(f"{name}_d{i}",
                   lambda z, i=i: limbs_of((M - 1) - a_val(z))[i]
                   if a_val(z) < M else 0)
        cs.bits(d, LIMB_BITS, f"{name}_d{i}r")
        d_limbs.append(d)
    # a + d == M-1 over the integers: per-limb with carry bits.
    # sums < 2^86 so carries are single bits.
    carry_prev: LC = {}
    for i in range(N_LIMBS):
        s = lc_add(a.limbs[i], d_limbs[i], carry_prev,
                   lc_const(-m1[i]))
        if i < N_LIMBS - 1:
            c = cs.aux(f"{name}_c{i}",
                       lambda z, s=s: (cs.eval_lc(s, z) * pow(1 << LIMB_BITS,
                                                              cs_f - 2, cs_f))
                       % cs_f)
            cs.assert_bool(c)
            cs.enforce_eq(s, lc_scale(c, 1 << LIMB_BITS))
            carry_prev = c
        else:
            cs.enforce_zero(s)


def nn_fold(cs: ConstraintSystem, a: NNValue,
            b: Union[NNValue, int], r: LC, M: int, name: str) -> NNValue:
    """a' = (a + r*b) mod M.

    Preconditions (caller-established): a < M limb-range-checked, b < M
    (limb-range-checked NNValue, or a small constant), r < 2^128
    (range-checked by the caller — the truncated fold challenge).
    Returns a canonical (< M) range-checked NNValue.
    """
    p = cs.f.p
    b_const = isinstance(b, int)
    if b_const:
        b_limbs_int = limbs_of(b)

    def val(z, limbs):
        return from_limbs([cs.eval_lc(l, z) for l in limbs])

    def host_vals(z):
        av = val(z, a.limbs)
        rv = cs.eval_lc(r, z)
        bv = b if b_const else val(z, b.limbs)
        total = av + rv * bv
        return total % M, total // M

    # witnesses: result limbs (canonical), quotient k
    ap_limbs = []
    for i in range(N_LIMBS):
        w = cs.aux(f"{name}_o{i}", lambda z, i=i: limbs_of(host_vals(z)[0])[i])
        cs.bits(w, LIMB_BITS, f"{name}_o{i}r")
        ap_limbs.append(w)
    k = cs.aux(f"{name}_k", lambda z: host_vals(z)[1])
    cs.bits(k, K_BITS, f"{name}_kr")

    # per-limb products r*b_i (wires); k*M_i folds as constant scaling
    m_limbs = limbs_of(M)
    rb = []
    for i in range(N_LIMBS):
        if b_const:
            rb.append(lc_scale(r, b_limbs_int[i]))
        else:
            rb.append(cs.mul(r, b.limbs[i], f"{name}_rb{i}"))

    # carry chain: D_i = a_i + rb_i - a'_i - k*M_i ;  D_0 = c0*2^85,
    # D_1 + c0 = c1*2^85, D_2 + c1 = 0.  Carries are signed; store
    # offset-encoded c + 2^C_BITS as C_BITS+1 bits.
    shift = 1 << LIMB_BITS
    offs = 1 << C_BITS

    def carry_val(z, i):
        av = val(z, a.limbs)
        rv = cs.eval_lc(r, z)
        bv = b if b_const else val(z, b.limbs)
        ap, kk = (av + rv * bv) % M, (av + rv * bv) // M
        apl = limbs_of(ap)
        al = [cs.eval_lc(l, z) for l in a.limbs]
        rbl = [rv * bi for bi in (b_limbs_int if b_const else
                                  [cs.eval_lc(l, z) for l in b.limbs])]
        c = 0
        for j in range(i + 1):
            c = (al[j] + rbl[j] - apl[j] - kk * m_limbs[j] + c) // shift
        return c

    carry: Optional[LC] = None
    for i in range(N_LIMBS):
        D = lc_add(a.limbs[i], rb[i], lc_scale(ap_limbs[i], -1),
                   lc_scale(k, -m_limbs[i]))
        if carry is not None:
            D = lc_add(D, carry)
        if i < N_LIMBS - 1:
            c_off = cs.aux(f"{name}_co{i}",
                           lambda z, i=i: carry_val(z, i) + offs)
            cs.bits(c_off, C_BITS + 1, f"{name}_cor{i}")
            c = lc_add(c_off, lc_const(-offs))
            cs.enforce_eq(D, lc_scale(c, shift))
            carry = c
        else:
            cs.enforce_zero(D)

    out = NNValue(ap_limbs)
    nn_enforce_canonical(cs, out, M, f"{name}_can")
    return out


def nn_select(cs: ConstraintSystem, cond: LC, t: NNValue, f: NNValue,
              name: str = "") -> NNValue:
    return NNValue([cs.ite(cond, t.limbs[i], f.limbs[i], f"{name}_s{i}")
                    for i in range(N_LIMBS)])


def nn_fold_host(a: int, b: int, r: int, M: int) -> int:
    """Host mirror of nn_fold."""
    return (a + r * b) % M
