"""2-cycle Nova IVC: host-side prover/verifier (constant-size proofs).

Replaces the round-1 transparent fold chain with real IVC, matching the
reference's RecursiveSNARK / CompressedSNARK pipeline
(reference src/backend/framework.rs:295-303, 642-754):

  per step i the prover (mirroring backend.ivc_circuit exactly):
    1. fold the last secondary instance into the running U2 (host NIFS),
    2. run the AUGMENTED PRIMARY circuit (application step + in-circuit
       verification of that fold) -> strict primary instance u1,
    3. fold u1 into the running U1,
    4. run the SECONDARY circuit (in-circuit verification of THAT fold)
       -> strict secondary instance u2 (held for the next step).

  The final proof is CONSTANT SIZE regardless of step count:
    { U1, U2, u2_last, T_last, zn, n } + two Spartan SNARKs — the verifier
    checks two 250-bit state hashes, folds (U2, u2_last) itself with the
    prover-supplied cross-term commitment, and verifies one Spartan proof
    per curve.

  Fiat-Shamir: the fold challenge r = Poseidon-RO(pp, U, u, T) truncated to
  128 bits; state hashes are Poseidon truncated to 250 bits so they embed
  in both fields (nova-snark's NUM_HASH_BITS trick).  Non-native (u, x)
  folds ride backend.nonnative's 85-bit limb representation — the SAME limb
  values are what both the host RO and the in-circuit sponge absorb.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..ec.pasta import PALLAS, VESTA, Curve, Point
from ..errors import VerifyError
from ..ops import field as F
from ..ops.poseidon import HostSponge, IOPattern
from ..utils.metrics import span
from . import nonnative as NN
from .ivc_circuit import (CHAL_BITS, HASH_BITS, IVC_RATE, AugmentedPrimary,
                          SecondaryCircuit)
from .nova import R1CSShape, RelaxedInstance, RelaxedWitness, VectorCommitter
from .spartan import SpartanProof, spartan_prove, spartan_verify


# ---------------------------------------------------------------------------
# host hashing spec (the circuits replay these bit-for-bit)
# ---------------------------------------------------------------------------

def pt3(pt: Point) -> List[int]:
    return [0, 1, 1] if pt is None else [pt[0], pt[1], 0]


@dataclass
class StrictInstance:
    comm_W: Point
    x: List[int]


def absorb_relaxed(U: RelaxedInstance) -> List[int]:
    return (pt3(U.comm_W) + pt3(U.comm_E) + NN.limbs_of(U.u)
            + NN.limbs_of(U.x[0]) + NN.limbs_of(U.x[1]))


def absorb_strict(u: StrictInstance) -> List[int]:
    return pt3(u.comm_W) + NN.limbs_of(u.x[0]) + NN.limbs_of(u.x[1])


def _sponge(field, elems: List[int], domain: bytes) -> int:
    io = IOPattern([("absorb", len(elems)), ("squeeze", 1)], domain=domain)
    sp = HostSponge(field, io, rate=IVC_RATE)
    sp.absorb([e % field.p for e in elems])
    return sp.squeeze(1)[0]


def state_hash_primary(pp: int, i: int, z0: List[int], z: List[int],
                       U2: RelaxedInstance) -> int:
    elems = [pp, i] + list(z0) + list(z) + absorb_relaxed(U2)
    return _sponge(F.FQ, elems, b"ivc_state") % (1 << HASH_BITS)


def state_hash_secondary(pp: int, i: int, U1: RelaxedInstance) -> int:
    elems = [pp, i] + absorb_relaxed(U1)
    return _sponge(F.FP, elems, b"ivc_state") % (1 << HASH_BITS)


def fold_ro(field, pp: int, U: RelaxedInstance, u: StrictInstance,
            T: Point) -> int:
    elems = [pp] + absorb_relaxed(U) + absorb_strict(u) + pt3(T)
    return _sponge(field, elems, b"ivc_fold") % (1 << CHAL_BITS)


def default_relaxed() -> RelaxedInstance:
    return RelaxedInstance(None, None, 0, [0, 0])


def dummy_strict() -> StrictInstance:
    return StrictInstance(None, [0, 0])


# ---------------------------------------------------------------------------
# host NIFS (per-side fold accumulator with cached matvecs)
# ---------------------------------------------------------------------------

class FoldAccumulator:
    """One side's running relaxed instance+witness.  ro_field is the field
    of the circuit that VERIFIES this side's folds (the other curve's
    scalar field)."""

    def __init__(self, shape: R1CSShape, wc: VectorCommitter,
                 ec: VectorCommitter, ro_field, pp: int):
        self.shape = shape
        self.wc = wc
        self.ec = ec
        self.ro_field = ro_field
        self.pp = pp
        self.M = shape.f.p
        self.curve = wc.cv
        self.U: Optional[RelaxedInstance] = None
        self.Wit: Optional[RelaxedWitness] = None
        self._az = self._bz = self._cz = None

    def init_default(self):
        n = self.shape.n_cons
        self.U = default_relaxed()
        self.Wit = RelaxedWitness([0] * self.shape.n_wit, [0] * n, 0, 0)
        self._az = [0] * n
        self._bz = [0] * n
        self._cz = [0] * n

    def init_from_strict(self, u: StrictInstance, W, blind: int):
        """Base case: U = relax(u) (E = 0, u-scalar = 1)."""
        from ..ops.native_fieldvec import PackedVec
        Wk = W if isinstance(W, PackedVec) else list(W)
        self.U = RelaxedInstance(u.comm_W, None, 1, list(u.x))
        self.Wit = RelaxedWitness(Wk, [0] * self.shape.n_cons, blind, 0)
        self._az, self._bz, self._cz = self._vectors(W, 1, u.x)

    def _vectors(self, W, u, x):
        return self.shape.matvecs(self.shape.z_vector(W, u, x))

    def fold(self, u2: StrictInstance, W2: List[int], blind2: int
             ) -> Point:
        """Fold a strict instance in; returns the cross-term commitment
        (what the verifying circuit / final verifier needs)."""
        from ..ops import native_fieldvec as FV
        p = self.M
        shape = self.shape
        az2, bz2, cz2 = self._vectors(W2, 1, u2.x)
        az1, bz1, cz1 = self._az, self._bz, self._cz
        u1 = self.U.u
        if FV.available():
            T = FV.cross_term(az1, bz1, cz1, az2, bz2, cz2, u1, p)
        else:
            T = [(az1[i] * bz2[i] + az2[i] * bz1[i] - u1 * cz2[i]
                  - cz1[i]) % p for i in range(shape.n_cons)]
        comm_T, blind_T = self.ec.commit(T)

        r = fold_ro(self.ro_field, self.pp, self.U, u2, comm_T)

        if FV.available():
            def fold_vec(a, b):
                return FV.fold_vec(a, b, r, p)
        else:
            def fold_vec(a, b):
                return [(x + r * y) % p for x, y in zip(a, b)]

        cvv = self.curve
        U, Wit = self.U, self.Wit
        self.U = RelaxedInstance(
            cvv.add(U.comm_W, cvv.mul(r, u2.comm_W)),
            cvv.add(U.comm_E, cvv.mul(r, comm_T)),
            (U.u + r) % p,
            [(a + r * b) % p for a, b in zip(U.x, u2.x)],
        )
        self.Wit = RelaxedWitness(
            fold_vec(Wit.W, W2),
            fold_vec(Wit.E, T),
            (Wit.W_blind + r * blind2) % p,
            (Wit.E_blind + r * blind_T) % p,
        )
        self._az = fold_vec(az1, az2)
        self._bz = fold_vec(bz1, bz2)
        self._cz = fold_vec(cz1, cz2)
        return comm_T


# ---------------------------------------------------------------------------
# public params + proof artifact
# ---------------------------------------------------------------------------

_SECONDARY_CACHE: dict = {}


def secondary_parts():
    """The secondary circuit is application-independent: build once."""
    if "x" not in _SECONDARY_CACHE:
        sec = SecondaryCircuit()
        shape2 = R1CSShape(sec.compiled, sec.io_names)
        wc2 = VectorCommitter(shape2.w_pad, curve=VESTA)
        ec2 = VectorCommitter(shape2.n_cons, curve=VESTA)
        _SECONDARY_CACHE["x"] = (sec, shape2, wc2, ec2)
    return _SECONDARY_CACHE["x"]


def pp_digest(shape1: R1CSShape, shape2: R1CSShape) -> int:
    h = hashlib.sha256(b"reef_ivc_pp")
    h.update(shape1.digest.to_bytes(32, "big"))
    h.update(shape2.digest.to_bytes(32, "big"))
    return int.from_bytes(h.digest(), "big") % (1 << HASH_BITS)


@dataclass
class IVCProof:
    """Constant-size IVC proof (the whole .proof fold layer)."""
    n_steps: int
    zn: List[int]
    U1_W: tuple
    U1_E: tuple
    U1_u: int
    U1_x: List[int]
    U2_W: tuple
    U2_E: tuple
    U2_u: int
    U2_x: List[int]
    u2_W: tuple
    u2_x: List[int]
    T_last: tuple
    spartan1: SpartanProof
    spartan2: SpartanProof


# ---------------------------------------------------------------------------
# mid-proof checkpoint/resume
# ---------------------------------------------------------------------------

@dataclass
class IVCCheckpoint:
    """PROVER-SECRET resumable state after step i (contains witnesses and
    blinds — handle like .cmtkey, never publish).

    The reference has no mid-proof checkpointing (a killed prover restarts
    from step 0; SURVEY §5) — Nova's IVC makes this state a complete
    resume point: the per-side folded (U, Wit) pairs, the held-over strict
    secondary instance, and the z chain.  The accumulators' cached matvec
    triples are LINEAR in (W, u, x) and are recomputed on restore."""
    pp: int
    i: int
    z0: List[int]
    z: List[int]
    U1_W: tuple
    U1_E: tuple
    U1_u: int
    U1_x: List[int]
    W1: List[int]
    E1: List[int]
    W1_blind: int
    E1_blind: int
    U2_W: tuple
    U2_E: tuple
    U2_u: int
    U2_x: List[int]
    W2: List[int]
    E2: List[int]
    W2_blind: int
    E2_blind: int
    u2_W: tuple
    u2_x: List[int]
    w2_last: List[int]
    w2_blind: int


def _acc_restore(acc: FoldAccumulator, cv, comm_W, comm_E, u, x, W, E,
                 W_blind, E_blind):
    p = acc.M
    acc.U = RelaxedInstance(cv.decompress(comm_W), cv.decompress(comm_E),
                            u % p, [v % p for v in x])
    acc.Wit = RelaxedWitness(list(W), list(E), W_blind % p, E_blind % p)
    acc._az, acc._bz, acc._cz = acc._vectors(acc.Wit.W, acc.U.u, acc.U.x)


class _CkptMixin:
    def checkpoint(self) -> IVCCheckpoint:
        assert self.i >= 1, "nothing to checkpoint"
        U1, W1t = self.acc1.U, self.acc1.Wit
        U2, W2t = self.acc2.U, self.acc2.Wit
        return IVCCheckpoint(
            pp=self.pp, i=self.i, z0=list(self.z0), z=list(self.z),
            U1_W=PALLAS.compress(U1.comm_W), U1_E=PALLAS.compress(U1.comm_E),
            U1_u=U1.u, U1_x=list(U1.x),
            W1=list(W1t.W), E1=list(W1t.E),
            W1_blind=W1t.W_blind, E1_blind=W1t.E_blind,
            U2_W=VESTA.compress(U2.comm_W), U2_E=VESTA.compress(U2.comm_E),
            U2_u=U2.u, U2_x=list(U2.x),
            W2=list(W2t.W), E2=list(W2t.E),
            W2_blind=W2t.W_blind, E2_blind=W2t.E_blind,
            u2_W=VESTA.compress(self.u2_last.comm_W),
            u2_x=list(self.u2_last.x),
            w2_last=list(self.w2_last[0]), w2_blind=self.w2_last[1])

    def restore(self, ck: IVCCheckpoint):
        """Rehydrate from a checkpoint (fresh RecursiveSNARK, same
        circuit stack).  Raises VerifyError on pp/shape mismatch."""
        from ..errors import VerifyError
        if ck.pp != self.pp:
            raise VerifyError("checkpoint pp digest does not match the "
                              "circuit stack")
        if ck.i < 1:
            raise VerifyError("checkpoint has no completed steps")
        if [v % F.Q for v in ck.z0] != self.z0:
            # same shapes but a different run (e.g. another document's
            # commitment salt): folding on would waste the whole remaining
            # prove only to fail verification
            raise VerifyError("checkpoint z0 does not match this run")
        self.i = ck.i
        self.z = [v % F.Q for v in ck.z]
        _acc_restore(self.acc1, PALLAS, ck.U1_W, ck.U1_E, ck.U1_u, ck.U1_x,
                     ck.W1, ck.E1, ck.W1_blind, ck.E1_blind)
        _acc_restore(self.acc2, VESTA, ck.U2_W, ck.U2_E, ck.U2_u, ck.U2_x,
                     ck.W2, ck.E2, ck.W2_blind, ck.E2_blind)
        self.u2_last = StrictInstance(VESTA.decompress(ck.u2_W),
                                      [v % F.P for v in ck.u2_x])
        self.w2_last = (list(ck.w2_last), ck.w2_blind % F.P)


# ---------------------------------------------------------------------------
# RecursiveSNARK
# ---------------------------------------------------------------------------

class RecursiveSNARK(_CkptMixin):
    def __init__(self, aug: AugmentedPrimary, shape1: R1CSShape,
                 wc1: VectorCommitter, ec1: VectorCommitter,
                 z0: List[int]):
        sec, shape2, wc2, ec2 = secondary_parts()
        self.aug = aug
        self.sec = sec
        self.shape1, self.wc1, self.ec1 = shape1, wc1, ec1
        self.shape2, self.wc2, self.ec2 = shape2, wc2, ec2
        self.pp = pp_digest(shape1, shape2)
        self.z0 = [v % F.Q for v in z0]
        self.z = list(self.z0)
        self.i = 0
        self.acc1 = FoldAccumulator(shape1, wc1, ec1, F.FP, self.pp)
        self.acc2 = FoldAccumulator(shape2, wc2, ec2, F.FQ, self.pp)
        self.acc2.init_default()
        self.u2_last: Optional[StrictInstance] = None
        self.w2_last: Optional[Tuple[List[int], int]] = None
        self._zout_idx = [aug.cs.names[n] for n in aug.step.z_out_names]

    def prove_step(self, app_wits: Dict[str, int], check: bool = False):
        i = self.i
        # 1. fold last secondary instance into U2 (the primary circuit
        #    verifies exactly this fold)
        if i == 0:
            U2_for_circ = default_relaxed()
            u2_for_circ = dummy_strict()
            T2: Point = None
        else:
            U2_for_circ = self.acc2.U
            u2_for_circ = self.u2_last
            T2 = self.acc2.fold(self.u2_last, *self.w2_last)

        # 2. primary circuit
        inputs = dict(app_wits)
        inputs.update(self.aug.ivc_witness(self.pp, self.z0, U2_for_circ,
                                           u2_for_circ, T2))
        wires = self.aug.compiled.witness_packed(inputs)
        if check:
            bad = self.aug.compiled.check_all(list(wires))
            assert bad is None, f"primary constraint {bad} unsatisfied"
        W1, x1 = self.shape1.split_wires(wires)
        comm_W1, blind1 = self.wc1.commit(W1)
        u1 = StrictInstance(comm_W1, x1)
        at = (wires.at if hasattr(wires, "at")
              else lambda j: wires[j] % F.Q)
        z_next = [at(j) for j in self._zout_idx]

        # 3. fold u1 into U1
        if i == 0:
            U1_for_circ = default_relaxed()      # circuit base branch
            T1: Point = None
            self.acc1.init_from_strict(u1, W1, blind1)
        else:
            U1_for_circ = self.acc1.U
            T1 = self.acc1.fold(u1, W1, blind1)

        # 4. secondary circuit
        inputs2 = self.sec.witness(self.pp, i, U1_for_circ, u1, T1)
        wires2 = self.sec.compiled.witness_packed(inputs2)
        if check:
            bad = self.sec.compiled.check_all(list(wires2))
            assert bad is None, f"secondary constraint {bad} unsatisfied"
        W2, x2 = self.shape2.split_wires(wires2)
        comm_W2, blind2 = self.wc2.commit(W2)
        self.u2_last = StrictInstance(comm_W2, x2)
        self.w2_last = (W2, blind2)

        self.z = z_next
        self.i += 1

    # ------------------------------------------------------------------

    def compress(self) -> IVCProof:
        """Final CompressedSNARK: fold (U2, u2_last) and emit one Spartan
        proof per curve (framework.rs:695-754's CompressedSNARK::prove)."""
        assert self.i >= 1, "no steps proven"
        U2_pre = self.acc2.U
        T_last = self.acc2.fold(self.u2_last, *self.w2_last)
        # The two Spartan proofs are independent; with the batched one-IPA
        # openings, one proof's single-threaded sumcheck phases overlap the
        # other's threaded MSM phases — threading them is a ~25% compress
        # win (pre-batching it LOST ~30% to MSM oversubscription).
        import threading
        res: list = [None, None]
        err: list = []

        def _run(slot, args):
            try:
                res[slot] = spartan_prove(*args)
            except Exception as e:     # surface in the caller
                err.append(e)

        th = threading.Thread(target=_run, args=(
            1, (self.shape2, self.wc2, self.ec2, self.acc2.U,
                self.acc2.Wit)))
        th.start()
        _run(0, (self.shape1, self.wc1, self.ec1, self.acc1.U,
                 self.acc1.Wit))
        with span("Prover", "wait_spartan2"):
            th.join()
        if err:
            raise err[0]
        sp1, sp2 = res

        def comp(cv, pt):
            return cv.compress(pt)

        U1 = self.acc1.U
        return IVCProof(
            n_steps=self.i, zn=list(self.z),
            U1_W=comp(PALLAS, U1.comm_W), U1_E=comp(PALLAS, U1.comm_E),
            U1_u=U1.u, U1_x=list(U1.x),
            U2_W=comp(VESTA, U2_pre.comm_W), U2_E=comp(VESTA, U2_pre.comm_E),
            U2_u=U2_pre.u, U2_x=list(U2_pre.x),
            u2_W=comp(VESTA, self.u2_last.comm_W),
            u2_x=list(self.u2_last.x),
            T_last=comp(VESTA, T_last), spartan1=sp1, spartan2=sp2)


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------

def verify(proof: IVCProof, shape1: R1CSShape, wc1: VectorCommitter,
           ec1: VectorCommitter, z0: List[int]) -> bool:
    """O(1) verification: two state hashes, one clear fold, two Spartan
    proofs.  Raises VerifyError (caught by callers) on malformed points."""
    _, shape2, wc2, ec2 = secondary_parts()
    pp = pp_digest(shape1, shape2)

    n = proof.n_steps
    if not isinstance(n, int) or n < 1:
        return False
    zn = [v % F.Q for v in proof.zn]
    if len(zn) != len(z0):
        return False
    if not all(isinstance(v, int) for v in
               list(proof.U1_x) + list(proof.U2_x) + list(proof.u2_x)
               + [proof.U1_u, proof.U2_u]):
        return False
    if len(proof.U1_x) != 2 or len(proof.U2_x) != 2 or len(proof.u2_x) != 2:
        return False

    U1 = RelaxedInstance(PALLAS.decompress(proof.U1_W),
                         PALLAS.decompress(proof.U1_E),
                         proof.U1_u % F.Q, [v % F.Q for v in proof.U1_x])
    U2 = RelaxedInstance(VESTA.decompress(proof.U2_W),
                         VESTA.decompress(proof.U2_E),
                         proof.U2_u % F.P, [v % F.P for v in proof.U2_x])
    u2 = StrictInstance(VESTA.decompress(proof.u2_W),
                        [v % F.P for v in proof.u2_x])
    T_last = VESTA.decompress(proof.T_last)

    # hash chain checks (bind n, z0, zn, and both running instances)
    if u2.x[0] != state_hash_primary(pp, n, [v % F.Q for v in z0], zn, U2):
        return False
    if u2.x[1] != state_hash_secondary(pp, n, U1):
        return False

    # final clear fold of (U2, u2_last)
    r = fold_ro(F.FQ, pp, U2, u2, T_last)
    p = F.P
    U2_final = RelaxedInstance(
        VESTA.add(U2.comm_W, VESTA.mul(r, u2.comm_W)),
        VESTA.add(U2.comm_E, VESTA.mul(r, T_last)),
        (U2.u + r) % p,
        [(a + r * b) % p for a, b in zip(U2.x, u2.x)],
    )

    # the two per-curve Spartan verifies are independent and their hot
    # loops (s-vector MSMs, matrix MLE evals) run in native code with the
    # GIL released: verify them in parallel (the reference leans on rayon
    # the same way, safa.rs:377)
    import threading
    res = [False]

    def _second():
        try:
            res[0] = spartan_verify(shape2, wc2, ec2, U2_final,
                                    proof.spartan2)
        except Exception:
            res[0] = False

    th = threading.Thread(target=_second)
    th.start()
    try:
        ok1 = spartan_verify(shape1, wc1, ec1, U1, proof.spartan1)
    finally:
        th.join()
    return ok1 and res[0]
