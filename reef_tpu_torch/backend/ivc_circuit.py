"""The 2-cycle Nova augmented circuits (in-circuit folding verifier).

The reference drives nova-snark's NovaAugmentedCircuit pair
(reference src/backend/framework.rs:295-303 via the nova fork): each
circuit of the cycle folds instances of the OTHER circuit — group operations
land on the curve whose base field is native, scalar (u, x) folds use the
non-native limb gadget (backend.nonnative), and the running state is
compressed into 250-bit Poseidon hashes that fit both fields.

Layout (mirrored exactly by the host logic in backend.ivc):

  primary   F'1 over Fq (E1=pallas commitments; folds E2/vesta instances):
      io  x = [ u2.x[1] pass-through , H_q(pp, i+1, z0, z_{i+1}, U2_new) ]
      checks (i>0):  u2.x[0] == H_q(pp, i, z0, z_i, U2)
      U2_new = is_base ? DEFAULT : NIFS.fold(U2, u2, T2)
      plus the whole application step circuit (backend.step_circuit)

  secondary F'2 over Fp (E2=vesta commitments; folds E1/pallas instances):
      io  x = [ u1.x[1] pass-through , H_p(pp, i+1, U1_new) ]
      checks (i>0):  u1.x[0] == H_p(pp, i, U1)
      U1_new = is_base ? relax(u1) : NIFS.fold(U1, u1, T1)

Soundness notes:
  - limb inputs are range-checked (< 2^85) but NOT canonicalized; a
    non-canonical representation changes the in-circuit RO absorbs and
    hashes, diverging from the host-side canonical values the final
    verifier recomputes — the chain then fails the final hash equality.
  - 255-bit decompositions of sponge squeezes admit one alias (v vs v+p)
    for ~half the range; the prover's choice at most doubles the FS
    soundness error per squeeze (negligible at 128-bit challenges) and any
    divergence from the host transcript again breaks the final hash.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..ec.pasta import PALLAS, Point
from ..ops import field as F
from ..ops.poseidon import IOPattern
from . import nonnative as NN
from .ec_gadgets import PointWires, padd_gadget, scalar_mul_gadget
from .nonnative import NNValue, nn_fold, nn_input, nn_select, nn_witness
from .r1cs import (LC, CircuitSponge, CompiledCircuit, ConstraintSystem,
                   lc_add, lc_const, lc_scale, lc_sub)
from .step_circuit import StepCircuit

HASH_BITS = 250
CHAL_BITS = 128
# The IVC-layer sponges (state hashes, fold RO) absorb ~15-35 elements per
# hash: rate 8 (t=9, 57 partial rounds) costs 48 constraints per absorbed
# element in-circuit vs rate 4's 72 — these hashes are OURS (the app-step
# nlookup FS stays arity-4 for reference parity, costs.rs:115-138).
IVC_RATE = 8
IVC_IO = ["ivc_x0", "ivc_x1"]


# ---------------------------------------------------------------------------
# affine point wires
# ---------------------------------------------------------------------------

class AffinePoint:
    """(x, y, inf) wires with canonical identity (0, 1, 1)."""

    __slots__ = ("x", "y", "inf")

    def __init__(self, x: LC, y: LC, inf: LC):
        self.x, self.y, self.inf = x, y, inf

    def to_proj(self) -> PointWires:
        return PointWires(self.x, self.y, lc_sub(lc_const(1), self.inf))

    def absorb_elems(self) -> List[LC]:
        return [self.x, self.y, self.inf]

    @staticmethod
    def identity() -> "AffinePoint":
        return AffinePoint(lc_const(0), lc_const(1), lc_const(1))


def alloc_point(cs: ConstraintSystem, name: str) -> AffinePoint:
    """Allocated affine point: inf boolean, canonical identity, on-curve."""
    x = cs.input(f"{name}_x")
    y = cs.input(f"{name}_y")
    inf = cs.input(f"{name}_inf")
    cs.assert_bool(inf)
    cs.enforce(inf, x, {})
    cs.enforce(inf, lc_sub(y, lc_const(1)), {})
    x2 = cs.mul(x, x)
    x3 = cs.mul(x2, x)
    y2 = cs.mul(y, y)
    cs.enforce(lc_sub(lc_const(1), inf),
               lc_sub(y2, lc_add(x3, lc_const(5))), {})
    return AffinePoint(x, y, inf)


def point_witness(name: str, pt: Point) -> Dict[str, int]:
    if pt is None:
        return {f"{name}_x": 0, f"{name}_y": 1, f"{name}_inf": 1}
    return {f"{name}_x": pt[0], f"{name}_y": pt[1], f"{name}_inf": 0}


def affinize(cs: ConstraintSystem, P: PointWires, name: str) -> AffinePoint:
    """Projective -> canonical affine (identity class has X=0, Y!=0)."""
    inf = cs.is_zero(P.Z, f"{name}_inf")

    def compute_zi(z, P=P):
        zv = cs.eval_lc(P.Z, z)
        if zv != 0:
            return pow(zv, cs.f.p - 2, cs.f.p)
        yv = cs.eval_lc(P.Y, z)
        return pow(yv, cs.f.p - 2, cs.f.p) if yv else 0

    zi = cs.aux(f"{name}_zi", compute_zi)
    cs.enforce(P.Z, zi, lc_sub(lc_const(1), inf))
    x = cs.mul(P.X, zi, f"{name}_ax")
    y = cs.mul(P.Y, zi, f"{name}_ay")
    cs.enforce(inf, lc_sub(y, lc_const(1)), {})
    return AffinePoint(x, y, inf)


def select_point_aff(cs: ConstraintSystem, cond: LC, a: AffinePoint,
                     b: AffinePoint) -> AffinePoint:
    return AffinePoint(cs.ite(cond, a.x, b.x), cs.ite(cond, a.y, b.y),
                       cs.ite(cond, a.inf, b.inf))


# ---------------------------------------------------------------------------
# truncation
# ---------------------------------------------------------------------------

def truncate(cs: ConstraintSystem, x: LC, keep: int, name: str
             ) -> Tuple[LC, List[LC]]:
    """Keep the low `keep` bits of a field element.  Returns (low_lc,
    low_bits_msb_first)."""
    bits = cs.bits(x, 255, name)          # LSB first
    low: LC = {}
    for j in range(keep):
        low = lc_add(low, lc_scale(bits[j], 1 << j))
    return low, list(reversed(bits[:keep]))


# ---------------------------------------------------------------------------
# instances in-circuit
# ---------------------------------------------------------------------------

class AllocRelaxed:
    __slots__ = ("W", "E", "u", "x0", "x1")

    def __init__(self, W: AffinePoint, E: AffinePoint, u: NNValue,
                 x0: NNValue, x1: NNValue):
        self.W, self.E, self.u, self.x0, self.x1 = W, E, u, x0, x1

    def absorb_elems(self) -> List[LC]:
        return (self.W.absorb_elems() + self.E.absorb_elems()
                + self.u.limbs + self.x0.limbs + self.x1.limbs)

    @staticmethod
    def default() -> "AllocRelaxed":
        return AllocRelaxed(AffinePoint.identity(), AffinePoint.identity(),
                            NNValue.constant(0), NNValue.constant(0),
                            NNValue.constant(0))


class AllocStrict:
    __slots__ = ("W", "x0", "x1")

    def __init__(self, W: AffinePoint, x0: NNValue, x1: NNValue):
        self.W, self.x0, self.x1 = W, x0, x1

    def absorb_elems(self) -> List[LC]:
        return self.W.absorb_elems() + self.x0.limbs + self.x1.limbs


def alloc_relaxed(cs: ConstraintSystem, name: str) -> AllocRelaxed:
    return AllocRelaxed(alloc_point(cs, f"{name}_W"),
                        alloc_point(cs, f"{name}_E"),
                        nn_input(cs, f"{name}_u"),
                        nn_input(cs, f"{name}_x0"),
                        nn_input(cs, f"{name}_x1"))


def alloc_strict(cs: ConstraintSystem, name: str) -> AllocStrict:
    return AllocStrict(alloc_point(cs, f"{name}_W"),
                       nn_input(cs, f"{name}_x0"),
                       nn_input(cs, f"{name}_x1"))


def relaxed_witness(name: str, U) -> Dict[str, int]:
    """Host assignment for alloc_relaxed (U: backend.ivc instance)."""
    out = {}
    out.update(point_witness(f"{name}_W", U.comm_W))
    out.update(point_witness(f"{name}_E", U.comm_E))
    out.update(nn_witness(f"{name}_u", U.u))
    out.update(nn_witness(f"{name}_x0", U.x[0]))
    out.update(nn_witness(f"{name}_x1", U.x[1]))
    return out


def strict_witness(name: str, u) -> Dict[str, int]:
    out = {}
    out.update(point_witness(f"{name}_W", u.comm_W))
    out.update(nn_witness(f"{name}_x0", u.x[0]))
    out.update(nn_witness(f"{name}_x1", u.x[1]))
    return out


def nn_recompose(v: NNValue) -> LC:
    return lc_add(v.limbs[0], lc_scale(v.limbs[1], 1 << NN.LIMB_BITS),
                  lc_scale(v.limbs[2], 1 << (2 * NN.LIMB_BITS)))


# ---------------------------------------------------------------------------
# hashing + folding gadgets
# ---------------------------------------------------------------------------

def sponge_hash(cs: ConstraintSystem, elems: List[LC], domain: bytes,
                keep: int, name: str) -> LC:
    io = IOPattern([("absorb", len(elems)), ("squeeze", 1)], domain=domain)
    sp = CircuitSponge(cs, io, rate=IVC_RATE)
    sp.absorb(elems)
    sq = sp.squeeze(1)[0]
    low, _ = truncate(cs, sq, keep, name)
    return low


def fold_gadget(cs: ConstraintSystem, pp: LC, U: AllocRelaxed,
                u2: AllocStrict, T: AffinePoint, M: int, name: str
                ) -> Tuple[AllocRelaxed, LC]:
    """In-circuit NIFS verifier: derive r from the RO, fold commitments
    (native group ops) and scalars (non-native mod M).  Mirrors
    backend.ivc.fold_ro + FoldAccumulator.fold exactly."""
    elems = [pp] + U.absorb_elems() + u2.absorb_elems() + T.absorb_elems()
    io = IOPattern([("absorb", len(elems)), ("squeeze", 1)],
                   domain=b"ivc_fold")
    sp = CircuitSponge(cs, io, rate=IVC_RATE)
    sp.absorb(elems)
    sq = sp.squeeze(1)[0]
    r_lc, r_bits_msb = truncate(cs, sq, CHAL_BITS, f"{name}_r")

    Wf = affinize(cs, padd_gadget(
        cs, U.W.to_proj(),
        scalar_mul_gadget(cs, r_bits_msb, u2.W.to_proj())), f"{name}_Wf")
    Ef = affinize(cs, padd_gadget(
        cs, U.E.to_proj(),
        scalar_mul_gadget(cs, r_bits_msb, T.to_proj())), f"{name}_Ef")
    uf = nn_fold(cs, U.u, 1, r_lc, M, f"{name}_u")
    x0f = nn_fold(cs, U.x0, u2.x0, r_lc, M, f"{name}_x0")
    x1f = nn_fold(cs, U.x1, u2.x1, r_lc, M, f"{name}_x1")
    return AllocRelaxed(Wf, Ef, uf, x0f, x1f), r_lc


def select_relaxed(cs: ConstraintSystem, cond: LC, a: AllocRelaxed,
                   b: AllocRelaxed) -> AllocRelaxed:
    return AllocRelaxed(select_point_aff(cs, cond, a.W, b.W),
                        select_point_aff(cs, cond, a.E, b.E),
                        nn_select(cs, cond, a.u, b.u),
                        nn_select(cs, cond, a.x0, b.x0),
                        nn_select(cs, cond, a.x1, b.x1))


def _expose_io(cs: ConstraintSystem, x0: LC, x1: LC) -> List[str]:
    for name, lc in ((IVC_IO[0], x0), (IVC_IO[1], x1)):
        w = cs.aux(name, lambda z, lc=lc: cs.eval_lc(lc, z))
        cs.enforce_eq(w, lc)
    return list(IVC_IO)


# ---------------------------------------------------------------------------
# the two augmented circuits
# ---------------------------------------------------------------------------

class AugmentedPrimary:
    """Application step circuit + the fold verifier for SECONDARY (E2)
    instances, over Fq.  Wraps an already-built StepCircuit (same
    ConstraintSystem)."""

    def __init__(self, step: StepCircuit):
        self.step = step
        cs = step.cs
        self.cs = cs
        arity = step.arity

        pp = cs.input("pp")
        step_i: LC = {cs.names["step_i"]: 1}
        is_base = cs.is_zero(step_i, "ivc_is_base")
        z0 = [cs.input(f"ivc_z0_{j}") for j in range(arity)]
        z_in = [{cs.names[n]: 1} for n in step.z_in_names]
        z_out = [{cs.names[n]: 1} for n in step.z_out_names]

        U2 = alloc_relaxed(cs, "U2")
        u2 = alloc_strict(cs, "u2")
        T2 = alloc_point(cs, "T2")

        h_in = sponge_hash(cs, [pp, step_i] + z0 + z_in + U2.absorb_elems(),
                           b"ivc_state", HASH_BITS, "hin")
        cs.enforce(lc_sub(lc_const(1), is_base),
                   lc_sub(nn_recompose(u2.x0), h_in), {})
        # base-case binding: the h_in check above is multiplied out at
        # step 0, so WITHOUT these constraints z_in would be a free choice
        # and "z0 reaches zn" would be forgeable from an arbitrary start
        # state (nova-snark instead feeds conditionally_select(z0, z_i,
        # is_base) into the step circuit — same relation, one mul per slot
        # either way)
        for j in range(arity):
            cs.enforce(is_base, lc_sub(z_in[j], z0[j]), {})

        folded, _ = fold_gadget(cs, pp, U2, u2, T2, F.P, "f2")
        U2_new = select_relaxed(cs, is_base, AllocRelaxed.default(), folded)

        h_out = sponge_hash(
            cs, [pp, lc_add(step_i, lc_const(1))] + z0 + z_out
            + U2_new.absorb_elems(), b"ivc_state", HASH_BITS, "hout")

        self.io_names = _expose_io(cs, nn_recompose(u2.x1), h_out)
        self.compiled = CompiledCircuit(cs)

    def ivc_witness(self, pp: int, z0_vals: List[int], U2, u2, T2: Point
                    ) -> Dict[str, int]:
        out = {"pp": pp}
        for j, v in enumerate(z0_vals):
            out[f"ivc_z0_{j}"] = v % F.Q
        out.update(relaxed_witness("U2", U2))
        out.update(strict_witness("u2", u2))
        out.update(point_witness("T2", T2))
        return out


class SecondaryCircuit:
    """Trivial application + the fold verifier for PRIMARY (E1) instances,
    over Fp.  Fixed shape — built once per process."""

    def __init__(self):
        cs = ConstraintSystem(F.FP)
        self.cs = cs
        pp = cs.input("pp")
        i = cs.input("i")
        is_base = cs.is_zero(i, "ivc_is_base")

        U1 = alloc_relaxed(cs, "U1")
        u1 = alloc_strict(cs, "u1")
        T1 = alloc_point(cs, "T1")

        h_in = sponge_hash(cs, [pp, i] + U1.absorb_elems(),
                           b"ivc_state", HASH_BITS, "hin")
        cs.enforce(lc_sub(lc_const(1), is_base),
                   lc_sub(nn_recompose(u1.x0), h_in), {})

        folded, _ = fold_gadget(cs, pp, U1, u1, T1, F.Q, "f1")
        relaxed_u1 = AllocRelaxed(u1.W, AffinePoint.identity(),
                                  NNValue.constant(1), u1.x0, u1.x1)
        U1_new = select_relaxed(cs, is_base, relaxed_u1, folded)

        h_out = sponge_hash(cs, [pp, lc_add(i, lc_const(1))]
                            + U1_new.absorb_elems(),
                            b"ivc_state", HASH_BITS, "hout")

        self.io_names = _expose_io(cs, nn_recompose(u1.x1), h_out)
        self.compiled = CompiledCircuit(cs)

    def witness(self, pp: int, i: int, U1, u1, T1: Point) -> Dict[str, int]:
        out = {"pp": pp, "i": i}
        out.update(relaxed_witness("U1", U1))
        out.update(strict_witness("u1", u1))
        out.update(point_witness("T1", T1))
        return out
