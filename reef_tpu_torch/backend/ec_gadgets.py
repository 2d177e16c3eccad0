"""In-circuit EC arithmetic: the building blocks of the IVC folding verifier.

Nova's augmented circuit verifies commitment folds (comm' = comm1 + r*comm2)
inside a circuit over the curve's BASE field (the curve-cycle trick: pallas
points have Fp coordinates, so a circuit over Fp checks pallas group ops
natively; framework.rs:1-8's G1/G2 pairing).  The reference gets this from
nova-snark's gadget library (the V1/V2 constants of costs.rs:7-8 are mostly
these scalar muls); here the gadgets are built on our ConstraintSystem:

  - points are projective (X, Y, Z) wire triples; addition uses the COMPLETE
    a=0 formulas (RCB16 Alg.7) — 12 multiplication constraints, no branches,
    identity/doubling/inverse all handled;
  - scalar multiplication is double-and-add over boolean-constrained bit
    wires (MSB first): ~27 constraints per bit;
  - `assert_points_equal` compares projective classes via cross-ratios
    (X1*Z2 = X2*Z1, Y1*Z2 = Y2*Z1) plus a both-infinite escape hatch.

These compose into `fold_commit_gadget` (comm' == comm1 + r*comm2), the core
relation the round-2 augmented circuit enforces per Hyrax commitment row.
"""

from __future__ import annotations

from typing import List, Tuple

from ..ec.pasta import Curve, Point
from ..ops import field as F
from .r1cs import LC, ConstraintSystem, lc_add, lc_const, lc_scale, lc_sub

B3 = 15  # 3*b for y^2 = x^3 + 5


class PointWires:
    """Projective point as circuit wires (or LCs)."""

    __slots__ = ("X", "Y", "Z")

    def __init__(self, X: LC, Y: LC, Z: LC):
        self.X, self.Y, self.Z = X, Y, Z

    @staticmethod
    def alloc(cs: ConstraintSystem, name: str) -> "PointWires":
        return PointWires(cs.input(f"{name}_x"), cs.input(f"{name}_y"),
                          cs.input(f"{name}_z"))

    @staticmethod
    def constant(cs: ConstraintSystem, pt: Point) -> "PointWires":
        if pt is None:
            return PointWires(lc_const(0), lc_const(1), lc_const(0))
        return PointWires(lc_const(pt[0]), lc_const(pt[1]), lc_const(1))

    @staticmethod
    def identity() -> "PointWires":
        return PointWires({}, lc_const(1), {})


def witness_point(pt: Point, name: str) -> dict:
    """Input assignment for an allocated point."""
    if pt is None:
        return {f"{name}_x": 0, f"{name}_y": 1, f"{name}_z": 0}
    return {f"{name}_x": pt[0], f"{name}_y": pt[1], f"{name}_z": 1}


def padd_gadget(cs: ConstraintSystem, P: PointWires, Q: PointWires
                ) -> PointWires:
    """Complete projective addition (12 mul constraints)."""
    mul = cs.mul
    t0 = mul(P.X, Q.X)
    t1 = mul(P.Y, Q.Y)
    t2 = mul(P.Z, Q.Z)
    t3 = mul(lc_add(P.X, P.Y), lc_add(Q.X, Q.Y))
    t3 = lc_sub(t3, lc_add(t0, t1))
    t4 = mul(lc_add(P.Y, P.Z), lc_add(Q.Y, Q.Z))
    t4 = lc_sub(t4, lc_add(t1, t2))
    x3 = mul(lc_add(P.X, P.Z), lc_add(Q.X, Q.Z))
    y3 = lc_sub(x3, lc_add(t0, t2))
    t0 = lc_scale(t0, 3)
    t2 = lc_scale(t2, B3)
    z3 = lc_add(t1, t2)
    t1 = lc_sub(t1, t2)
    y3 = lc_scale(y3, B3)
    x3n = lc_sub(cs.mul(t3, t1), cs.mul(t4, y3))
    y3n = lc_add(cs.mul(y3, t0), cs.mul(t1, z3))
    z3n = lc_add(cs.mul(z3, t4), cs.mul(t0, t3))
    return PointWires(x3n, y3n, z3n)


def select_point(cs: ConstraintSystem, cond: LC, a: PointWires,
                 b: PointWires) -> PointWires:
    return PointWires(cs.ite(cond, a.X, b.X), cs.ite(cond, a.Y, b.Y),
                      cs.ite(cond, a.Z, b.Z))


def scalar_mul_gadget(cs: ConstraintSystem, bits: List[LC],
                      P: PointWires) -> PointWires:
    """bits (MSB first, boolean-constrained by the caller) * P."""
    acc = PointWires.identity()
    for b in bits:
        acc = padd_gadget(cs, acc, acc)
        added = padd_gadget(cs, acc, P)
        acc = select_point(cs, b, added, acc)
    return acc


def assert_points_equal(cs: ConstraintSystem, A: PointWires, B: PointWires):
    """Same projective class: X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1.

    NB for the identity (0:y:0) the Y cross-term also vanishes against any
    finite point's Z only if that point is also at infinity — with Y != 0
    maintained by the complete formulas, (0:y:0) equals only (0:y':0)."""
    cs.enforce(A.X, B.Z, cs.mul(B.X, A.Z))
    cs.enforce(A.Y, B.Z, cs.mul(B.Y, A.Z))


def fold_commit_gadget(cs: ConstraintSystem, comm1: PointWires,
                       comm2: PointWires, r_bits: List[LC],
                       folded: PointWires):
    """Enforce folded == comm1 + r*comm2 (the per-commitment core of Nova's
    in-circuit folding verifier)."""
    r_c2 = scalar_mul_gadget(cs, r_bits, comm2)
    out = padd_gadget(cs, comm1, r_c2)
    assert_points_equal(cs, out, folded)


def bits_input(cs: ConstraintSystem, name: str, n: int) -> List[LC]:
    """n boolean-constrained input wires, MSB first."""
    out = []
    for j in range(n):
        b = cs.input(f"{name}_{j}")
        cs.assert_bool(b)
        out.append(b)
    return out


def bits_witness(name: str, value: int, n: int) -> dict:
    return {f"{name}_{j}": (value >> (n - 1 - j)) & 1 for j in range(n)}
