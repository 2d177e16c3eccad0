"""In-circuit fold-step verification: the heart of the round-2 IVC.

A circuit over Fp (pallas base field) that verifies ONE fold of the chain in
`backend.nova`:

  - replays the Poseidon fold transcript (same sponge semantics as
    PoseidonTranscript: absorb U's commitments/u/x, the step's commitment/x,
    the cross-term commitment; squeeze the challenge r) with the
    CircuitSponge gadget over Fp — natively, since pallas coordinates and
    the fold transcript both live in Fp;
  - bit-decomposes r and checks the commitment folds
    comm_W' = comm_W + r*comm_W2 and comm_E' = comm_E + r*T with the
    complete-formula EC gadgets (backend.ec_gadgets).

The relation verified here is the TRANSCRIPT REPLAY + COMMITMENT FOLDS
only: u and x enter as host-absorbed digests, and the scalar folds
u' = u + r, x' = x + r*x2 (Fq arithmetic, non-native over this Fp circuit)
are NOT constrained by this prototype — they live in the full augmented
IVC circuits (backend.ivc_circuit), which use the carry-witnessed
non-native fold gadget (backend.nonnative) and absorb the x elements
themselves instead of digests.  This module remains as the standalone
proof-of-relation used by the fold-gadget tests.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..ec.pasta import PALLAS, Point
from ..ops import field as F
from .ec_gadgets import (PointWires, assert_points_equal, bits_input,
                         bits_witness, padd_gadget, scalar_mul_gadget,
                         select_point, witness_point)
from .r1cs import (CircuitSponge, CompiledCircuit, ConstraintSystem, LC,
                   lc_add, lc_const, lc_scale, lc_sub)

fp = F.FP
cv = PALLAS
NBITS = 255


def _absorb_point_gadget(cs: ConstraintSystem, sponge: CircuitSponge,
                         name: str) -> PointWires:
    """Allocate an affine-compressed point (x, parity, inf) + its projective
    wires; absorb (x_or_0, parity_or_2) exactly like
    PoseidonTranscript.append_point."""
    # compressed form wires (what the transcript absorbs)
    cx = cs.input(f"{name}_cx")
    cflag = cs.input(f"{name}_cflag")
    sponge.absorb([cx, cflag])
    # projective wires for the group math, tied to the compressed form:
    # x*z_inv == cx when not infinity is delegated to the caller's equality
    # checks; here we allocate and tie the AFFINE form directly: (cx, y, 1)
    # or the identity (0 : 1 : 0) when cflag == 2.
    y = cs.input(f"{name}_y")
    is_inf = cs.is_eq(cflag, lc_const(2), f"{name}_isinf")
    # canonical identity encoding: cflag==2 forces cx==0 and y==1, so an
    # identity-flagged absorb offers no free transcript-grinding input
    cs.enforce(is_inf, cx, {})
    cs.enforce(is_inf, lc_sub(y, lc_const(1)), {})
    X = cs.ite(is_inf, lc_const(0), cx)
    Y = cs.ite(is_inf, lc_const(1), y)
    Z = cs.ite(is_inf, lc_const(0), lc_const(1))
    # curve membership (y^2 = x^3 + 5) for non-identity
    x2 = cs.mul(cx, cx)
    x3 = cs.mul(x2, cx)
    y2 = cs.mul(y, y)
    on_curve = lc_sub(y2, lc_add(x3, lc_const(5)))
    cs.enforce(cs.not_(is_inf), on_curve, {})
    # parity binding: y's low bit equals cflag when finite
    ybits = cs.bits(y, NBITS, f"{name}_ybits")
    cs.enforce(cs.not_(is_inf), lc_sub(ybits[0], cflag), {})
    return PointWires(X, Y, Z)


def witness_compressed(pt: Point, name: str) -> Dict[str, int]:
    x, flag = cv.compress(pt)
    return {f"{name}_cx": x, f"{name}_cflag": flag,
            f"{name}_y": pt[1] if pt is not None else 1}


class FoldStepCircuit:
    """Verifies one fold step.  Public io: sponge state in/out + everything
    the verifier chains; r is derived, never an input."""

    def __init__(self):
        cs = ConstraintSystem(fp)
        self.cs = cs

        # sponge state in (the transcript is threaded across steps)
        state_in = [cs.input(f"sp_in_{i}") for i in range(5)]
        sponge = CircuitSponge.__new__(CircuitSponge)
        sponge.cs = cs
        sponge.state = list(state_in)
        sponge.pos = 0
        sponge.squeezing = False

        # absorb U (comm_W, comm_E, u, x-digest), step (comm_W2, x2-digest),
        # T — mirroring fold_challenge's absorb order with x vectors replaced
        # by a host-absorbed running digest (the augmented circuit absorbs
        # the x elements themselves; digesting keeps this prototype's io
        # small)
        UW = _absorb_point_gadget(cs, sponge, "UW")
        UE = _absorb_point_gadget(cs, sponge, "UE")
        u_in = cs.input("u_in")
        x_dig = cs.input("x_digest")
        sponge.absorb([u_in, x_dig])
        W2 = _absorb_point_gadget(cs, sponge, "W2")
        x2_dig = cs.input("x2_digest")
        sponge.absorb([x2_dig])
        T = _absorb_point_gadget(cs, sponge, "T")

        r = sponge.squeeze(1)[0]
        # bit-decompose r (soundness: a non-canonical decomp shifts the
        # scalar by P, changing the folded points — self-defeating)
        r_bits_lsb = cs.bits(r, NBITS, "r")
        r_bits = list(reversed(r_bits_lsb))

        # folded commitments (public io, compressed + projective, NOT
        # absorbed — they chain into the next step's U slots)
        def alloc_folded(name):
            cx = cs.input(f"{name}_cx")
            cflag = cs.input(f"{name}_cflag")
            y = cs.input(f"{name}_y")
            is_inf = cs.is_eq(cflag, lc_const(2), f"{name}_isinf")
            cs.enforce(is_inf, cx, {})
            cs.enforce(is_inf, lc_sub(y, lc_const(1)), {})
            X = cs.ite(is_inf, lc_const(0), cx)
            Y = cs.ite(is_inf, lc_const(1), y)
            Z = cs.ite(is_inf, lc_const(0), lc_const(1))
            x2_ = cs.mul(cx, cx)
            x3_ = cs.mul(x2_, cx)
            y2_ = cs.mul(y, y)
            cs.enforce(cs.not_(is_inf), lc_sub(y2_, lc_add(x3_, lc_const(5))),
                       {})
            return PointWires(X, Y, Z)

        Wf = alloc_folded("Wf")
        Ef = alloc_folded("Ef")

        rW2 = scalar_mul_gadget(cs, r_bits, W2)
        assert_points_equal(cs, padd_gadget(cs, UW, rW2), Wf)
        rT = scalar_mul_gadget(cs, r_bits, T)
        assert_points_equal(cs, padd_gadget(cs, UE, rT), Ef)

        # sponge state out (public io)
        for i in range(5):
            out = cs.input(f"sp_out_{i}")
            cs.enforce_eq(out, sponge.state[i])

        self.r_lc = r
        self.compiled = CompiledCircuit(cs)

    def witness(self, sponge_state_in: List[int], U_W: Point, U_E: Point,
                u_in: int, x_digest: int, W2: Point, x2_digest: int,
                T: Point) -> Tuple[Dict[str, int], int, List[int]]:
        """Host-side: runs the same transcript math to produce the input
        assignment; returns (inputs, r, sponge_state_out)."""
        from ..ops.poseidon_constants import host_permutation

        # replicate the sponge evolution on the host
        state = [s % fp.p for s in sponge_state_in]
        pos = [0]

        def absorb(vals):
            for v in vals:
                if pos[0] == 4:
                    state[:] = host_permutation(fp.p, state)
                    pos[0] = 0
                state[1 + pos[0]] = (state[1 + pos[0]] + v) % fp.p
                pos[0] += 1

        def compressed_vals(pt):
            x, flag = cv.compress(pt)
            return [x % fp.p, flag]

        absorb(compressed_vals(U_W))
        absorb(compressed_vals(U_E))
        absorb([u_in % fp.p, x_digest % fp.p])
        absorb(compressed_vals(W2))
        absorb([x2_digest % fp.p])
        absorb(compressed_vals(T))
        # squeeze
        state[:] = host_permutation(fp.p, state)
        r = state[1]

        folded_W = cv.add(U_W, cv.mul(r, W2))
        folded_E = cv.add(U_E, cv.mul(r, T))

        inputs = {f"sp_in_{i}": s % fp.p for i, s in
                  enumerate(sponge_state_in)}
        inputs.update(witness_compressed(U_W, "UW"))
        inputs.update(witness_compressed(U_E, "UE"))
        inputs.update({"u_in": u_in % fp.p, "x_digest": x_digest % fp.p,
                       "x2_digest": x2_digest % fp.p})
        inputs.update(witness_compressed(W2, "W2"))
        inputs.update(witness_compressed(T, "T"))
        inputs.update(witness_compressed(folded_W, "Wf"))
        inputs.update(witness_compressed(folded_E, "Ef"))
        inputs.update({f"sp_out_{i}": s % fp.p for i, s in enumerate(state)})
        return inputs, r, list(state)
