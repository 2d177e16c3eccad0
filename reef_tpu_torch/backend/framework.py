"""Prover/verifier orchestration: commit -> prove -> verify.

The reference's framework.rs pipelines a solver thread against Nova folding
(framework.rs:81-166); here a solver thread streams witness batches through
a bounded queue into a fold worker (run_prover below) — witness generation
overlaps the IVC step's commits, which run in the native MSM (GIL released)
or on the device where backend/routes.py routes them.  Protocol:

  commit:  Hyrax doc commitment (or Poseidon Merkle tree), public part +
           a prover secret seed for blinds (the reference serializes the
           whole polynomial+decommitments into the shared .cmt artifact,
           commitment.rs:56-69 — split here so the verifier never sees the
           document).
  prove:   SAFA solve -> per-batch step-circuit witnesses -> 2-cycle Nova
           IVC (backend.ivc: each step folds the previous instance and
           verifies that fold in-circuit) -> one CompressedSNARK (two
           Spartan proofs) -> consistency proof for the final doc running
           claim (+ CAP: Poseidon(v,salt)=d linked to the Pedersen
           v-commitment used by the dot-product argument).
  verify:  re-derive table/circuit/shape deterministically (framework.rs:
           770-783), O(1) IVC verification (two 250-bit state hashes, one
           clear fold, two Spartan verifies), zn layout checks (exit state,
           stack clear, table MLE eval), consistency verify with the eval
           point bound to zn.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..frontend.safa import SAFA
from ..ops import field as F
from ..ops.poseidon import HostSponge, IOPattern
from ..utils.metrics import count, span
from . import commitment as CM
from . import routes
from .commitment import (ConsistencyProof, NLDocCommitment, SigmaEvalProof,
                         Transcript, commit_doc)
from .costs import logmn
from .merkle import MerkleCommitment
from .nova import (FoldingProver, R1CSShape, RelaxedInstance, VectorCommitter,
                   verify_fold_chain)
from .r1cs import CompiledCircuit, ConstraintSystem, lc_const
from .spartan import SpartanProof, spartan_prove, spartan_verify
from .step_circuit import StepCircuit, hide_pattern
from .table import TransitionTable, doc_transform
from .witness import solve_and_batch

f = F.FQ


@dataclass
class ReefCommitment:
    """Public commitment artifact (.cmt)."""
    nldoc: Optional[NLDocCommitment]           # public part only
    merkle_root: Optional[int]
    orig_doc_len: int
    udoc_len: int

    def doc_commit_hash(self) -> int:
        return self.nldoc.doc_commit_hash if self.nldoc else 0

    def hash_salt(self) -> int:
        return self.nldoc.hash_salt if self.nldoc else 0


@dataclass
class Proofs:
    """Proof artifact (.proof) — CONSTANT SIZE in the number of folds.

    ivc carries {U1, U2, u2_last, T_last, zn, n} + one Spartan SNARK per
    curve (the reference's Proofs{compressed_snark, consist_proof},
    framework.rs:53-57)."""
    ivc: "IVCProof"
    consist: Optional[ConsistencyProof]
    cap: Optional["CapProof"]


# ---------------------------------------------------------------------------
# CAP: Poseidon(v, salt) = d with v linked to a Pedersen commitment
# ---------------------------------------------------------------------------

def consistency_circuit() -> CompiledCircuit:
    """R1CS for Poseidon(v, salt) == d (the reference's ConsistencyCircuit,
    commitment.rs:537-622)."""
    cs = ConstraintSystem(f)
    d = cs.input("d")
    v = cs.input("v")
    salt = cs.input("salt")
    from .r1cs import CircuitSponge
    sp = CircuitSponge(cs, hide_pattern())
    sp.absorb([v, salt])
    out = sp.squeeze(1)[0]
    cs.enforce_eq(out, d)
    return CompiledCircuit(cs)


@dataclass
class CapProof:
    d: int
    comm_W: tuple           # compressed point
    spartan: SpartanProof
    v_open: object          # IPA proof


_CAP_CACHE: dict = {}


def _cap_setup():
    if "x" not in _CAP_CACHE:
        circ = consistency_circuit()
        shape = R1CSShape(circ, ["d"])
        wc = VectorCommitter(shape.w_pad)
        ec = VectorCommitter(shape.n_cons)
        _CAP_CACHE["x"] = (circ, shape, wc, ec)
    return _CAP_CACHE["x"]


def cap_prove(v: int, salt: int, v_blind: int) -> CapProof:
    from .commitment import eq_evals, shared_scalar_gens
    from .ipa import ipa_prove
    from .nova import RelaxedWitness
    from ..ec.pasta import PALLAS as _cv
    circ, shape, wc, ec = _cap_setup()
    d = StepCircuit._hide_host(v, salt)
    wires = circ.witness({"d": d, "v": v, "salt": salt})
    assert circ.check_all(wires) is None
    W, x = shape.split_wires(wires)
    comm_W, blind_W = wc.commit(W)
    zero_E = [0] * shape.n_cons
    U = RelaxedInstance(comm_W, None, 1, x)
    Wit = RelaxedWitness(W, zero_E, blind_W, 0)
    sp = spartan_prove(shape, wc, ec, U, Wit)
    # open W at v's wire index against C_v (one-hot eq vector -> W[idx] = v)
    idx = shape.wit_index("v")
    bits = [(idx >> (wc.n_vars - 1 - j)) & 1 for j in range(wc.n_vars)]
    w_pad = W + [0] * (wc.n - len(W))
    R = eq_evals(F.FQ, bits)
    C_v = shared_scalar_gens().commit([v % f.p], v_blind)
    v_open = ipa_prove(wc.gens, shared_scalar_gens().G[0], w_pad, blind_W,
                       R, v % f.p, v_blind, comm_W, C_v,
                       Transcript(b"cap_open"))
    return CapProof(d, _cv.compress(comm_W), sp, v_open)


def cap_verify(proof: CapProof, v_commit) -> bool:
    from .commitment import eq_evals, shared_scalar_gens
    from .ipa import ipa_verify
    from .nova import RelaxedInstance
    from ..ec.pasta import PALLAS as _cv
    circ, shape, wc, ec = _cap_setup()
    comm_W = _cv.decompress(proof.comm_W)
    U = RelaxedInstance(comm_W, None, 1, [proof.d])
    if not spartan_verify(shape, wc, ec, U, proof.spartan):
        return False
    idx = shape.wit_index("v")
    bits = [(idx >> (wc.n_vars - 1 - j)) & 1 for j in range(wc.n_vars)]
    R = eq_evals(F.FQ, bits)
    return ipa_verify(wc.gens, shared_scalar_gens().G[0], R, comm_W,
                      v_commit, proof.v_open, Transcript(b"cap_open"))


# ---------------------------------------------------------------------------
# committer
# ---------------------------------------------------------------------------

def run_committer(doc_codes: List[int], ab_codes: List[int], merkle: bool,
                  seed: Optional[int] = None
                  ) -> Tuple[ReefCommitment, Optional[NLDocCommitment]]:
    """Returns (public commitment, prover-secret commitment state)."""
    with span("CommitmentGen", "doc_transform"):
        udoc = doc_transform(ab_codes, doc_codes)
    if merkle:
        mc = MerkleCommitment(udoc)
        return (ReefCommitment(None, mc.commitment, len(doc_codes),
                               len(udoc)), None)
    dc = commit_doc(udoc, seed=seed)
    return (ReefCommitment(dc.public_part(), None, len(doc_codes),
                           len(udoc)), dc)


# ---------------------------------------------------------------------------
# shared setup (prover + verifier re-derive identically)
# ---------------------------------------------------------------------------

def pub_setup(safa: SAFA, commit: ReefCommitment, batch_size: int,
              projections: bool, hybrid: bool, merkle: bool,
              udoc: Optional[List[int]] = None):
    """Deterministic public setup (framework.rs:910-976): table + step
    circuit + the AUGMENTED primary circuit (application + in-circuit fold
    verifier) and its commitment keys."""
    from .ivc_circuit import AugmentedPrimary
    proj = safa.projection() if projections else None
    # the table is doc-CONTENT-independent (it holds udoc only for
    # witness lookups): cache by (safa identity, lengths, flags) so a
    # serve worker proving one policy over many same-length docs pays
    # the SAFA walk + cost model once.  The cached tt keeps a strong
    # safa ref, so the id() key cannot be reused while the entry lives.
    tkey = (id(safa), commit.udoc_len, commit.orig_doc_len, batch_size,
            proj, hybrid, merkle)
    base_tt = _TT_CACHE.get(tkey)
    if base_tt is None:
        count("Compiler", "table_cache_miss")
        with span("Compiler", "table"):
            tt = TransitionTable(safa, udoc, commit.udoc_len,
                                 commit.orig_doc_len, batch_size=batch_size,
                                 projection=proj, hybrid=hybrid,
                                 merkle=merkle)
        if len(_TT_CACHE) > 8:
            _TT_CACHE.clear()
        _TT_CACHE[tkey] = tt
    else:
        count("Compiler", "table_cache_hit")
        import copy
        tt = copy.copy(base_tt)
        tt.udoc = udoc
    mc = None
    if merkle:
        assert udoc is not None or commit.merkle_root is not None
        if udoc is not None:
            mc = MerkleCommitment(udoc)
            assert mc.commitment == commit.merkle_root
        else:
            mc = _VerifierMerkle(commit.merkle_root, commit.udoc_len)
    # the circuit stack is deterministic in the table's structural
    # parameters + the baked-in commitment constants: cache it so a
    # prover+verifier pair (or a test suite) builds it once.  The doc
    # commitment hash is one constant in a few places (StepCircuit
    # .hash_sites), so the key keeps only whether it is zero (a zero hash
    # leaves A's entry out) and a hit under another hash restamps it:
    # every document of one structure shares the circuit, the shape, the
    # native witness program and matrices, and the committers with their
    # device bases
    h = commit.doc_commit_hash()
    key = (tt.num_states, tt.num_chars, tt.max_offsets, len(tt.table),
           tuple(tt.table[:2]), tt.doc_len(), tt.hybrid_len,
           tt.batch_size, tt.max_stack, tt.max_branches, tt.kid_padding,
           tt.eps_code, tt.eof_code, tt.star_offset, tt.ep_num,
           tt.udoc_len, tt.doc_subset,
           tuple(tt.proj_chunk_idx) if tt.proj_chunk_idx else None,
           h != 0, commit.merkle_root,
           mc.height if mc else None, merkle, hybrid)
    cached = _CIRCUIT_CACHE.get(key)
    if cached is None:
        count("Compiler", "circuit_cache_miss")
        with span("Compiler", "circuit"):
            circuit = StepCircuit(tt, h, merkle_commitment=mc)
            aug = AugmentedPrimary(circuit)
            shape = R1CSShape(aug.compiled, aug.io_names)
            wc = VectorCommitter(shape.w_pad)
            ec = VectorCommitter(shape.n_cons)
        if len(_CIRCUIT_CACHE) > 8:
            _CIRCUIT_CACHE.clear()
        _CIRCUIT_CACHE[key] = (circuit, aug, shape, wc, ec)
    else:
        count("Compiler", "circuit_cache_hit")
        circuit, aug, shape, wc, ec = cached
        if circuit.doc_commit_hash != h % f.p:
            count("Compiler", "circuit_restamp")
            with span("Compiler", "restamp"):
                shape.restamp_A(circuit.restamp_hash(h))
        # rebind the fresh table (carries udoc for witness generation)
        circuit.tt = tt
        aug.step.tt = tt
    return tt, circuit, aug, shape, wc, ec, mc


_CIRCUIT_CACHE: dict = {}
_TT_CACHE: dict = {}


class _VerifierMerkle:
    """Root + height only (what the verifier needs to build the circuit)."""

    def __init__(self, root: int, udoc_len: int):
        self.commitment = root
        self.height = logmn(udoc_len // 2) + 1 if udoc_len > 2 else 1


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------

def run_prover(commit: ReefCommitment, dc_secret: Optional[NLDocCommitment],
               safa: SAFA, doc_codes: List[int], batch_size: int = 0,
               projections: bool = False, hybrid: bool = False,
               merkle: bool = False, metrics=None,
               checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 8) -> Proofs:
    """checkpoint_path enables MID-PROOF checkpoint/resume (an extension
    the reference lacks — a killed prover there restarts folding from step
    0, SURVEY §5): every checkpoint_every folds the resumable IVC state is
    written there (PROVER-SECRET, like the .cmtkey), and a prover started
    with an existing checkpoint file resumes folding after its last saved
    step (witness batches before it are re-solved — deterministic — but
    not re-folded or re-committed).  The file is removed once the proof
    completes."""
    import os as _os
    from ..utils.metrics import Metrics
    from ..utils import serialize as SZ
    from .ivc import RecursiveSNARK, secondary_parts
    mt = metrics or Metrics()
    with span("Prover", "doc_transform"):
        udoc = doc_transform(safa.ab, doc_codes)
    mt.tic("Compiler", "r1cs_init")
    tt, circuit, aug, shape, wc, ec, mc = pub_setup(
        safa, commit, batch_size, projections, hybrid, merkle, udoc)
    mt.stop("Compiler", "r1cs_init")
    mt.r1cs("Prover", "step_circuit", aug.compiled.num_constraints)

    salt = commit.hash_salt()
    z0 = circuit.z0(salt, tt.table[0])
    rs = RecursiveSNARK(aug, shape, wc, ec, z0)
    with span("Prover", "prewarm"):
        _, _, wc2, ec2 = secondary_parts()
        routes.prewarm([c.gens for c in (wc, ec, wc2, ec2)])
    skip_folds = 0
    if checkpoint_path and _os.path.exists(checkpoint_path):
        rs.restore(SZ.load(checkpoint_path, kind="ckpt"))
        skip_folds = rs.i
        print(f"resuming from checkpoint: {skip_folds} folds done")
    last_res = None
    mt.tic("Solver", "fa_solver+wit")

    # solver/prover pipeline (the reference's two-thread design,
    # framework.rs:98-165): app witness generation (sumcheck-heavy python)
    # overlaps the IVC step (circuit eval + native MSMs, which release the
    # GIL) through a bounded channel.
    import queue
    import threading

    chan: "queue.Queue" = queue.Queue(maxsize=4)
    fold_err = []

    def fold_worker():
        i = 0
        while True:
            wits = chan.get()
            if wits is None:
                return
            try:
                if i >= skip_folds:         # pre-checkpoint: already folded
                    with span("Prover", "fold_step"):
                        rs.prove_step(wits)
                    count("Prover", "fold_steps")
                    if checkpoint_path and rs.i % checkpoint_every == 0:
                        SZ.save(checkpoint_path, "ckpt", rs.checkpoint())
            except Exception as e:  # surface in the main thread
                fold_err.append(e)
                # keep draining so a producer blocked on the full bounded
                # queue can never deadlock against a dead worker
                chan.task_done()
                while True:
                    if chan.get() is None:
                        chan.task_done()
                        return
                    chan.task_done()
            chan.task_done()
            i += 1

    worker = threading.Thread(target=fold_worker, daemon=True)
    worker.start()
    batches = solve_and_batch(tt, circuit, doc_codes,
                              commit.doc_commit_hash(), salt,
                              merkle_commitment=mc)
    while True:
        with span("Solver", "solve"):
            batch = next(batches, None)
        if batch is None or fold_err:
            break
        wits, last_res = batch
        with span("Solver", "wait_fold"):
            chan.put(wits)
    with span("Solver", "wait_fold"):
        chan.put(None)  # always: the worker drains to the sentinel on error
        worker.join()
    if fold_err:
        raise fold_err[0]
    mt.stop("Solver", "fa_solver+wit")

    # The consistency/CAP proofs depend only on the final doc claim (not on
    # compress), and both sides bottom out in GIL-releasing native MSMs —
    # run them CONCURRENTLY with the CompressedSNARK (the reference runs
    # them serially, framework.rs:695-754; the overlap shaves most of the
    # consistency wall off the warm prove).
    consist_box: list = [None, None, None]   # consist, cap, error

    def _consistency():
        import secrets
        try:
            # this thread runs concurrently with compress: its MSMs and
            # IPAs stay on the host, so that one thread at a time launches
            # device work
            with routes.host_only():
                mt.tic("Prover", "consistency_proof")
                if hybrid:
                    q, v = last_res.hyb_next_q, last_res.hyb_next_v
                else:
                    q, v = last_res.doc_next_q, last_res.doc_next_v
                # one v-commitment shared by the dot-prod argument and the
                # CAP
                v_blind = secrets.randbelow(f.p)
                consist_box[0] = CM.prove_consistency(
                    dc_secret, tt.table, tt.proj_chunk_idx, q, v,
                    proj=tt.doc_subset is not None, hybrid=hybrid,
                    v_blind=v_blind)
                consist_box[1] = cap_prove(v, salt, v_blind)
                mt.stop("Prover", "consistency_proof")
        except Exception as e:               # surface in the caller
            consist_box[2] = e

    cth = None
    if not merkle:
        cth = threading.Thread(target=_consistency, daemon=True)
        cth.start()

    mt.tic("Prover", "compressed_snark")
    ivc_proof = rs.compress()
    mt.stop("Prover", "compressed_snark")

    if cth is not None:
        with span("Prover", "wait_consistency"):
            cth.join()
        if consist_box[2] is not None:
            raise consist_box[2]
    consist, cap = consist_box[0], consist_box[1]

    if checkpoint_path and _os.path.exists(checkpoint_path):
        _os.remove(checkpoint_path)          # proof complete; state consumed
    return Proofs(ivc_proof, consist, cap)


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------

def run_verifier(commit: ReefCommitment, safa: SAFA, proofs: Proofs,
                 batch_size: int = 0, projections: bool = False,
                 hybrid: bool = False, merkle: bool = False,
                 metrics=None) -> bool:
    """Clean-reject wrapper: malformed prover data (bad points, wrong
    structure) raises VerifyError in the parsing layers and rejects here."""
    from ..errors import VerifyError
    try:
        return _run_verifier(commit, safa, proofs, batch_size, projections,
                             hybrid, merkle, metrics)
    except (VerifyError, TypeError, IndexError, KeyError):
        return False


def _run_verifier(commit: ReefCommitment, safa: SAFA, proofs: Proofs,
                  batch_size: int = 0, projections: bool = False,
                  hybrid: bool = False, merkle: bool = False,
                  metrics=None) -> bool:
    from ..utils.metrics import Metrics
    from . import ivc as IVC
    from .sumcheck import verifier_mle_eval
    mt = metrics or Metrics()

    mt.tic("Verifier", "setup")
    tt, circuit, aug, shape, wc, ec, mc = pub_setup(
        safa, commit, batch_size, projections, hybrid, merkle, udoc=None)
    mt.stop("Verifier", "setup")

    arity = circuit.arity
    salt = commit.hash_salt()
    z0 = circuit.z0(salt, tt.table[0])

    mt.tic("Verifier", "snark_verification")
    # O(1) IVC verification: hash-chain checks (binding n, z0, zn and both
    # running instances), one clear fold, two Spartan SNARKs.  The IVC
    # check runs in a thread overlapping the consistency/CAP checks below
    # (their hot loops are native MSMs with the GIL released).
    if not isinstance(proofs.ivc, IVC.IVCProof):
        return False
    if len(proofs.ivc.zn) != arity:
        return False
    import threading
    ivc_res = [False]

    def _ivc_check():
        try:
            with span("Verifier", "ivc_check"):
                ivc_res[0] = IVC.verify(proofs.ivc, shape, wc, ec, z0)
        except Exception:
            ivc_res[0] = False

    ivc_th = threading.Thread(target=_ivc_check)
    ivc_th.start()
    zn = [v % f.p for v in proofs.ivc.zn]
    mt.stop("Verifier", "snark_verification")

    def _layout_and_consistency() -> bool:
        # 3. zn layout checks (framework.rs:830-875)
        sc_l, doc_l, hyb_l = circuit.sc_l, circuit.doc_l, circuit.hyb_l
        if zn[0] != tt.exit_state % f.p:
            return False
        if circuit.mode == "split":
            nl_q = zn[1:1 + sc_l]
            nl_v = zn[1 + sc_l]
            hash_slot = zn[2 + sc_l + doc_l]
            sp_slot = zn[3 + sc_l + doc_l]
        elif circuit.mode == "hybrid":
            hash_slot = zn[1 + hyb_l]
            sp_slot = zn[2 + hyb_l]
            nl_q = nl_v = None
        else:
            nl_q = zn[1:1 + sc_l]
            nl_v = zn[1 + sc_l]
            sp_slot = zn[2 + sc_l]
            hash_slot = None
        if sp_slot != 0:
            return False
        if nl_q is not None and verifier_mle_eval(f, tt.table,
                                                  nl_q) != nl_v:
            return False

        # 4. consistency (doc side)
        if not merkle:
            cp = proofs.consist
            if cp is None or proofs.cap is None:
                return False
            if cp.hash_d != hash_slot:
                return False
            # Bind the eval point: the verifier recomputes the expected
            # running q from zn's circuit-carried doc claim point (split:
            # the nldoc slots; hybrid: the combined hq slots) + the
            # deterministically re-derived projection chunk bits, and
            # rejects a proof whose consistency eval runs at any other
            # point.  Without this the doc MLE could be opened at a
            # prover-chosen q', unlinking the committed document from the
            # circuit's claim.
            if hybrid:
                circ_q = zn[1:1 + hyb_l]
            else:
                circ_q = zn[2 + sc_l:2 + sc_l + doc_l]
            try:
                expected_q = CM.adjust_running_q(
                    commit.nldoc.n_vars, circ_q, tt.proj_chunk_idx,
                    tt.doc_subset is not None, hybrid)
            except AssertionError:
                return False
            if [v % f.p for v in cp.running_q] != \
                    [v % f.p for v in expected_q]:
                return False
            if not CM.verify_consistency(
                    commit.nldoc, cp, table=tt.table,
                    q=None if not hybrid else circ_q):
                return False
            # CAP: Poseidon(v,salt)=hash_d, v committed with the SAME
            # commitment the dot-product argument used
            cap = proofs.cap
            if cap.d != hash_slot:
                return False
            v_commit = CM.PALLAS.decompress(cp.v_commit)
            if not cap_verify(cap, v_commit):
                return False
        return True

    # layout + consistency/CAP run concurrently with the threaded IVC
    # check started above
    mt.tic("Verifier", "consistency_verification")
    try:
        with span("Verifier", "consistency"):
            rest_ok = _layout_and_consistency()
    finally:
        with span("Verifier", "wait_ivc"):
            ivc_th.join()
    mt.stop("Verifier", "consistency_verification")
    return rest_ok and ivc_res[0]
