"""The per-fold step circuit: lookups, cursor/stack machine, nlookup gadgets.

Re-design of the reference's NFAStepCircuit (r1cs.rs:557-1606 constraint
synthesis + nova.rs:868-1399 wiring) on the direct gadget library.  Protocol
math (v-encoding, nlookup Fiat-Shamir order, sumcheck chain, stack/cursor
semantics, z layout) matches SURVEY.md section 3.5; wiring is LC-direct
instead of name-rewired.

z layout (split mode, matching framework.rs:830-865):
    [state, nl_q (lT), nl_v, doc_q (lD), H(doc_v,salt), sp, stack(ms), cursor]
hybrid:  [state, hq (lH), H(hv,salt), sp, stack, cursor]
merkle:  [state, q (lT), v, sp, stack, cursor]

Deliberate divergences from the reference (documented soundness fixes):
  - cursor_0 continuity IS enforced: cursor_0 = pop ? cursor_popped :
    cursor_in (the reference builds this ITE then discards it, r1cs.rs:1184);
  - per-lookup q bits carry booleanity constraints;
  - the doc commitment hash is absorbed as a circuit constant, not a free
    witness (nova.rs:645-649 allocates it unconstrained);
  - the input-side hidden doc running claim is checked against
    Poseidon(prev_dv, salt) except at step 0 (the reference never binds the
    input side, nova.rs:930-936 + 1087-1090), using the step index input
    that our folding layer provides;
  - stack output slots are fully chained through ITEs in every case (the
    reference leaves non-popped output slots unconstrained on pop steps).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..ops import field as F
from ..ops.poseidon import IOPattern
from .costs import logmn
from .r1cs import (LC, CircuitSponge, CompiledCircuit, ConstraintSystem,
                   lc_add, lc_const, lc_scale, lc_sub)
from .sumcheck import nlookup_pattern
from .table import TransitionTable


def hide_pattern() -> IOPattern:
    return IOPattern([("absorb", 2), ("squeeze", 1)], domain=b"hide")


class StepCircuit:
    """Builds (once) the R1CS for one folding step of batch_size transitions."""

    def __init__(self, tt: TransitionTable, doc_commit_hash: int,
                 merkle_commitment=None):
        self.tt = tt
        self.doc_commit_hash = doc_commit_hash
        self.merkle_commitment = merkle_commitment
        self.mode = ("merkle" if tt.merkle else
                     "hybrid" if tt.hybrid_len is not None else "split")
        self.sc_l = logmn(len(tt.table))          # T-table sumcheck rounds
        self.doc_l = logmn(tt.doc_len())          # doc sumcheck rounds
        self.hyb_l = logmn(tt.hybrid_len) if tt.hybrid_len else 0
        cs = ConstraintSystem(F.FQ)
        self.cs = cs
        self._build()
        self.compiled = CompiledCircuit(cs, self.output_lcs)

    # ------------------------------------------------------------------

    @property
    def arity(self) -> int:
        tt = self.tt
        if self.mode == "split":
            return 1 + self.sc_l + 1 + self.doc_l + 1 + 1 + tt.max_stack + 1
        if self.mode == "hybrid":
            return 1 + self.hyb_l + 1 + 1 + tt.max_stack + 1
        return 1 + self.sc_l + 1 + 1 + tt.max_stack + 1

    def z0(self, salt: int, table0: int) -> List[int]:
        """Initial z vector (mirrors framework.rs:168-247 setup())."""
        from ..ops.poseidon_constants import host_permutation
        tt = self.tt
        z = [0]
        if self.mode == "split":
            z += [0] * self.sc_l + [table0 % F.Q]
            z += [0] * self.doc_l + [self._hide_host(0, salt)]
        elif self.mode == "hybrid":
            z += [0] * self.hyb_l + [self._hide_host(table0 % F.Q, salt)]
        else:
            z += [0] * self.sc_l + [table0 % F.Q]
        z += [0] + [tt.kid_padding] * tt.max_stack + [0]
        return z

    @staticmethod
    def _hide_host(v: int, salt: int) -> int:
        """Host-side Poseidon(v, salt) hiding hash (nova.rs calc_d)."""
        from ..ops.poseidon import HostSponge
        sp = HostSponge(F.FQ, hide_pattern())
        sp.absorb([v % F.Q, salt % F.Q])
        return sp.squeeze(1)[0]

    # ------------------------------------------------------------------

    def _build(self):
        cs = self.cs
        tt = self.tt
        bs = tt.batch_size
        S, C, O = tt.num_states, tt.num_chars, tt.max_offsets

        # ---------------- input wires (z first, then step privates) ------
        self.z_in_names: List[str] = []

        def zin(name):
            self.z_in_names.append(name)
            return cs.input(name)

        state0 = zin("state_0")
        if self.mode == "split":
            nl_run_q = [zin(f"nl_run_q_{j}") for j in range(self.sc_l)]
            nl_run_v = zin("nl_prev_running_claim")
            doc_run_q = [zin(f"nldoc_run_q_{j}") for j in range(self.doc_l)]
            doc_v_hash_in = zin("doc_v_hash_in")
        elif self.mode == "hybrid":
            hyb_run_q = [zin(f"nlhybrid_run_q_{j}") for j in range(self.hyb_l)]
            hyb_v_hash_in = zin("hyb_v_hash_in")
        else:
            nl_run_q = [zin(f"nl_run_q_{j}") for j in range(self.sc_l)]
            nl_run_v = zin("nl_prev_running_claim")
        sp_in = zin("stack_ptr_in")
        stack_in = [zin(f"stack_in_{i}") for i in range(tt.max_stack)]
        cursor_in = zin("cursor_in")
        assert len(self.z_in_names) == self.arity

        step_i = cs.input("step_i")           # public step counter from Nova
        salt = cs.input("hash_salt")

        chars = [cs.input(f"char_{i}") for i in range(bs)]
        char_los = [cs.input(f"char_lo_{i}") for i in range(bs)]
        char_his = [cs.input(f"char_hi_{i}") for i in range(bs)]
        states = [state0] + [cs.input(f"state_{i+1}") for i in range(bs)]
        lowers = [cs.input(f"lower_offset_{i}") for i in range(bs)]
        uppers = [cs.input(f"upper_offset_{i}") for i in range(bs)]
        offsets = [cs.input(f"offset_{i}") for i in range(bs)]
        rels = [cs.input(f"rel_{i}") for i in range(bs)]
        cursors_rest = [cs.input(f"cursor_{i+1}") for i in range(bs)]
        kids = [cs.input(f"forall_0_kid_{k}") for k in range(tt.max_branches)]
        cursor_popped = cs.input("cursor_popped")

        is_first = cs.is_zero(step_i, "is_first")

        # ---------------- stack machine (batch position 0) ----------------
        rel0 = rels[0]
        is_pop = cs.is_eq(rel0, lc_const(3), "is_pop")
        rel0_small = cs.or_(cs.or_(cs.is_zero(rel0),
                                   cs.is_eq(rel0, lc_const(1))),
                            cs.is_eq(rel0, lc_const(2)))
        is_push = cs.and_(cs.not_(rel0_small), cs.not_(is_pop))

        # cursor_0: pop restores the pushed cursor (ref builds-and-drops this)
        cursor0 = cs.ite(is_pop, cursor_popped, cursor_in, "cursor_0")
        cursors = [cursor0] + cursors_rest

        # push: rel0 == 4 + sum kid_k * S^{k+1} when pushing
        hashed = lc_const(4)
        st_bits = logmn(S) + 1
        for k in range(tt.max_branches):
            hashed = lc_add(hashed, lc_scale(kids[k], S ** (k + 1)))
            cs.assert_geq(lc_const(S), kids[k], st_bits, f"kidrange_{k}")
        cs.enforce(is_push, lc_sub(hashed, rel0), {})

        stack_cur = list(stack_in)
        ptr = sp_in
        pad = lc_const(tt.kid_padding)
        for b in range(tt.max_branches):
            active = cs.and_(is_push, cs.not_(cs.is_eq(kids[b], pad)))
            to_push = lc_add(lc_scale(cursor0, S), kids[b])
            for i in range(tt.max_stack):
                sel = cs.and_(active, cs.is_eq(ptr, lc_const(i)))
                stack_cur[i] = cs.ite(sel, to_push, stack_cur[i])
            ptr = lc_add(ptr, active)

        # pop: read slot ptr-1, must equal cursor_popped*S + state_1
        ptr_out = lc_sub(ptr, is_pop)
        ms_bits = logmn(tt.max_stack) + 2
        cs.assert_fits(ptr_out, ms_bits, "ptr_out_range")
        popped_val: LC = {}
        for i in range(tt.max_stack):
            sel = cs.and_(is_pop, cs.is_eq(ptr_out, lc_const(i)))
            popped_val = lc_add(popped_val, cs.mul(sel, stack_cur[i]))
        to_pop = lc_add(lc_scale(cursor_popped, S), states[1])
        cs.enforce(is_pop, lc_sub(popped_val, to_pop), {})
        # popped cursor rewinds: cursor_in >= cursor_popped on pop
        cur_bits = logmn(max(tt.udoc_len, tt.max_offsets)) + 1
        cp_eff = cs.mul(is_pop, cursor_popped)
        cs.assert_geq(cursor_in, cp_eff, cur_bits, "pop_rewind")

        stack_out = stack_cur
        self._sp_out = ptr_out
        self._stack_out = stack_out

        # forall ops only at batch position 0 (r1cs.rs not_forall_circ)
        for j in range(1, bs):
            relj = rels[j]
            small = cs.or_(cs.or_(cs.is_zero(relj),
                                  cs.is_eq(relj, lc_const(1))),
                           cs.is_eq(relj, lc_const(2)))
            cycle = cs.is_eq(states[j], states[j + 1])
            cs.assert_true(cs.or_(small, cycle))

        # ---------------- lookup encodings + range checks -----------------
        # Rows carry a char RANGE [char_lo, char_hi] (width 1 for per-char
        # edges; real ranges for full-unicode derivative-class edges): the
        # doc-bound char must fall inside the looked-up row's range —
        # char_lo <= char <= char_hi, checked by bit decomposition (the
        # differences are < C when honest; a dishonest witness wraps mod p
        # into a >cbits-bit value and fails the decomposition).
        bit_limit = logmn(S) + 1
        cbits = logmn(C) + 2
        vs: List[LC] = []
        for i in range(bs):
            cs.assert_geq(lc_const(S), states[i], bit_limit, f"st_rng_{i}")
            # Pin BOTH range digits canonically to [0, C] before the
            # relative checks: without this a forged (char_lo - t,
            # char_hi + t*C) pair leaves v_i unchanged (char_lo's weight
            # in v_i is exactly C times char_hi's) while widening the
            # accepted char window.  assert_fits rejects wrapped
            # negatives; assert_geq(C, .) caps the high side (honest EOF
            # rows carry char == eof_code == C, table.py make_num_ab).
            # With digits in [0, C] the only surviving alias of
            # lo*C + hi is (lo-1, hi+C) with hi == 0, which needs an
            # honest row with c_lo > c_hi == 0 — rows always satisfy
            # c_lo <= c_hi, so the decomposition is effectively unique.
            cs.assert_fits(char_los[i], cbits, f"ch_lo_fit_{i}")
            cs.assert_geq(lc_const(C), char_los[i], cbits,
                          f"ch_lo_cap_{i}")
            cs.assert_fits(char_his[i], cbits, f"ch_hi_fit_{i}")
            cs.assert_geq(lc_const(C), char_his[i], cbits,
                          f"ch_hi_cap_{i}")
            cs.assert_geq(chars[i], char_los[i], cbits, f"ch_lo_{i}")
            cs.assert_geq(char_his[i], chars[i], cbits, f"ch_hi_{i}")
            v_i = lc_add(
                lc_scale(rels[i], S * S * C * C * O * O),
                lc_scale(states[i], S * C * C * O * O),
                lc_scale(states[i + 1], C * C * O * O),
                lc_scale(char_los[i], C * O * O),
                lc_scale(char_his[i], O * O),
                lc_scale(lowers[i], O),
                uppers[i],
            )
            vs.append(v_i)
        cs.assert_geq(lc_const(S), states[bs], bit_limit, "st_rng_out")

        # ---------------- cursor circuit ----------------------------------
        for j in range(bs):
            cs.enforce_eq(cursors[j + 1], lc_add(cursors[j], offsets[j]))
            cs.assert_geq(cursors[j + 1], cursors[j], cur_bits, f"cur_mono_{j}")
            cs.assert_geq(offsets[j], lowers[j], cur_bits, f"off_lo_{j}")
            is_star = cs.is_eq(uppers[j], lc_const(tt.star_offset))
            # star: lower < max_offsets; else offset <= upper < max_offsets
            in_upper = cs.all_([
                self._fits_bool(lc_sub(uppers[j], offsets[j]), cur_bits,
                                f"off_hi_{j}"),
                self._fits_bool(lc_sub(lc_const(O), uppers[j]), cur_bits,
                                f"up_rng_{j}")])
            low_ok = self._fits_bool(lc_sub(lc_const(O), lowers[j]), cur_bits,
                                     f"lo_rng_{j}")
            cs.assert_true(cs.ite(is_star, low_ok, in_upper))

        # ---------------- nlookup gadgets ---------------------------------
        if self.mode == "split":
            nl_out = self._nlookup(
                "nl", vs, len(tt.table), nl_run_q, nl_run_v, None, None)
            dq_bits, doc_out = self._doc_nlookup(chars, cursors, doc_run_q,
                                                 salt, doc_v_hash_in,
                                                 is_first)
            self._q_ordering("nldoc", dq_bits, chars, cursors, tt.doc_len(),
                             hybrid=False)
            out = [states[bs]]
            out += nl_out["sc_rs"] + [nl_out["next_v"]]
            out += doc_out["sc_rs"] + [doc_out["hidden_next"]]
            out += [self._sp_out] + self._stack_out + [cursors[bs]]
        elif self.mode == "hybrid":
            hv_prev = cs.input("nlhybrid_prev_running_claim")
            # input hash check (except step 0)
            prev_hash = self._hide(hv_prev, salt)
            ok = cs.is_eq(prev_hash, hyb_v_hash_in)
            cs.assert_true(cs.or_(is_first, ok))
            all_vs = vs + chars
            hyb_out = self._nlookup("nlhybrid", all_vs, tt.hybrid_len,
                                    hyb_run_q, hv_prev, self.doc_commit_hash,
                                    None)
            dq_bits = hyb_out["q_bits"][bs:2 * bs]
            self._q_ordering("nlhybrid", dq_bits, chars, cursors,
                             tt.doc_len() + len(tt.table), hybrid=True)
            hidden_next = self._hide(hyb_out["next_v"], salt)
            out = [states[bs]]
            out += hyb_out["sc_rs"] + [hidden_next]
            out += [self._sp_out] + self._stack_out + [cursors[bs]]
        else:  # merkle
            nl_out = self._nlookup(
                "nl", vs, len(tt.table), nl_run_q, nl_run_v, None, None)
            self._merkle_lookups(chars, cursors)
            out = [states[bs]]
            out += nl_out["sc_rs"] + [nl_out["next_v"]]
            out += [self._sp_out] + self._stack_out + [cursors[bs]]

        assert len(out) == self.arity
        self.output_lcs = out
        # materialize outputs as wires so the folding layer can expose them
        # as public io (x = z_in ++ z_out ++ [step_i])
        self.z_out_names = []
        for k, lc in enumerate(out):
            name = f"z_out_{k}"
            w = cs.aux(name, lambda z, lc=lc: cs.eval_lc(lc, z))
            cs.enforce_eq(w, lc)
            self.z_out_names.append(name)
        self.io_names = self.z_in_names + self.z_out_names + ["step_i"]

    # ------------------------------------------------------------------

    def _fits_bool(self, x: LC, n: int, name: str) -> LC:
        """Bool LC: does x (as an integer < p) fit in n bits?  Implemented as
        an unconditional decomposition of a prover-chosen value plus an
        equality flag — used inside ITE branches where the check is
        conditional."""
        cs = self.cs
        # prover supplies y = x if it fits (else anything that fits)
        def compute(z, x=x):
            v = cs.eval_lc(x, z)
            return v if v < (1 << n) else 0

        y = cs.aux(name + "_clamp", compute)
        cs.bits(y, n, name + "_cbits")
        return cs.is_eq(y, x, name + "_fitflag")

    def _hide(self, v: LC, salt: LC) -> LC:
        sp = CircuitSponge(self.cs, hide_pattern())
        sp.absorb([v, salt])
        return sp.squeeze(1)[0]

    def _nlookup(self, tag: str, vs: List[LC], t_size: int,
                 run_q: List[LC], run_v: LC, doc_hash: Optional[int],
                 q_override: Optional[List[List[LC]]]) -> Dict:
        """The nlookup verification gadget (r1cs.rs:1560-1606) with the
        in-circuit Fiat-Shamir sponge (nova.rs:585-681)."""
        cs = self.cs
        sc_l = logmn(t_size)
        m = len(vs)
        num_cqs = math.ceil(m * sc_l / 254.0)

        # q bits (prover inputs, boolean)
        q_bits: List[List[LC]] = []
        for i in range(m):
            row = []
            for j in range(sc_l):
                b = cs.input(f"{tag}_eq_{i}_q_{j}")
                cs.assert_bool(b)
                row.append(b)
            q_bits.append(row)

        # combined q packing (LC-only; protocol drops boundary bits)
        combined: List[LC] = []
        cq_lc: LC = {}
        slot = 1
        cq = 0
        for i in range(m):
            for j in range(sc_l):
                if (i * sc_l) + j >= 254 * (cq + 1) or (i == m - 1
                                                        and j == sc_l - 1):
                    cq += 1
                    combined.append(cq_lc)
                    cq_lc = {}
                    slot = 1
                else:
                    cq_lc = lc_add(cq_lc, lc_scale(q_bits[i][j], slot))
                    slot *= 2
        assert len(combined) == num_cqs

        # g coefficients (prover inputs)
        gs = [[cs.input(f"{tag}_sc_g_{j+1}_{part}") for part in
               ("xsq", "x", "const")] for j in range(sc_l)]
        next_v = cs.input(f"{tag}_next_running_claim")

        # Fiat-Shamir
        io = nlookup_pattern(m, sc_l, num_cqs, doc_hash is not None, tag)
        from .costs import NL_RATE
        sponge = CircuitSponge(cs, io, rate=NL_RATE)
        absorb = [] if doc_hash is None else [lc_const(self.doc_commit_hash)]
        absorb += combined + vs + run_q + [run_v]
        sponge.absorb(absorb)
        claim_r = sponge.squeeze(1)[0]

        # lhs Horner: sum r^i v_i + r^{m+1} run_v
        lhs = cs.horner([lc_const(0)] + vs + [run_v], claim_r)

        # sumcheck chain
        sc_rs: List[LC] = []
        claim = lhs
        for j in range(sc_l):
            xsq, x, con = gs[j]
            cs.enforce_eq(claim, lc_add(xsq, x, con, con))
            sponge.absorb([con, x, xsq])
            r_j = sponge.squeeze(1)[0]
            sc_rs.append(r_j)
            # claim = con + r*(x + r*xsq)
            inner = cs.mul(r_j, lc_add(x, cs.mul(r_j, xsq)))
            claim = lc_add(con, inner)
        last_claim = claim

        # eq evals + domino
        eq_evals = []
        for i in range(m + 1):
            qrow = q_bits[i] if i < m else run_q
            prod: Optional[LC] = None
            for j in range(sc_l):
                qb = qrow[j]
                rj = sc_rs[j]
                # qb*rj + (1-qb)*(1-rj) = 1 - qb - rj + 2 qb rj
                term = lc_add(lc_const(1), lc_scale(qb, -1), lc_scale(rj, -1),
                              lc_scale(cs.mul(qb, rj), 2))
                prod = term if prod is None else cs.mul(prod, term)
            eq_evals.append(prod)
        eq_eval = cs.horner([lc_const(0)] + eq_evals, claim_r)
        cs.enforce_eq(cs.mul(eq_eval, next_v), last_claim)

        return {"sc_rs": sc_rs, "next_v": next_v, "q_bits": q_bits,
                "claim_r": claim_r}

    def _doc_nlookup(self, chars, cursors, doc_run_q, salt, doc_v_hash_in,
                     is_first):
        """Split-mode doc commitment nlookup (r1cs.rs nlookup_doc_commit)
        with the input-hash chaining fix."""
        cs = self.cs
        dv_prev = cs.input("nldoc_prev_running_claim")
        prev_hash = self._hide(dv_prev, salt)
        ok = cs.is_eq(prev_hash, doc_v_hash_in)
        cs.assert_true(cs.or_(is_first, ok))

        out = self._nlookup("nldoc", list(chars), self.tt.doc_len(),
                            doc_run_q, dv_prev, self.doc_commit_hash, None)
        out["hidden_next"] = self._hide(out["next_v"], salt)
        return out["q_bits"], out

    def _q_ordering(self, tag: str, q_bits_rows, chars, cursors,
                    doc_len: int, hybrid: bool):
        """Tie doc lookup indices to cursors / EPSILON (r1cs.rs:1423-1497)."""
        cs = self.cs
        tt = self.tt
        ell = len(q_bits_rows[0])
        for i, row in enumerate(q_bits_rows):
            full_q: LC = {}
            for j in range(ell):
                full_q = lc_add(full_q, lc_scale(row[j], 1 << (ell - 1 - j)))
            eps_loc = tt.ep_num
            cursor_term = cursors[i]
            if hybrid:
                half = tt.hybrid_len // 2
                eps_loc += half
                cursor_term = lc_add(cursor_term, lc_const(half))
            if tt.doc_subset is not None:
                ds0 = tt.doc_subset[0]
                eps_loc -= ds0
                cursor_term = lc_add(cursor_term, lc_const(-ds0))
            is_eps = cs.is_eq(chars[i], lc_const(tt.eps_code))
            expect = cs.ite(is_eps, lc_const(eps_loc), cursor_term)
            cs.enforce_eq(full_q, expect)

    def _hash_absorb(self, elems: List[LC]) -> LC:
        """Fixed-arity Poseidon hash gadget (absorb n, squeeze 1)."""
        io = IOPattern([("absorb", len(elems)), ("squeeze", 1)])
        sp = CircuitSponge(self.cs, io)
        sp.absorb(elems)
        return sp.squeeze(1)[0]

    def _merkle_lookups(self, chars, cursors):
        """Merkle mode: bind lookup indices to cursors/EPSILON and verify a
        Poseidon authentication path per lookup against the ROOT CONSTANT
        (the reference allocates the root as a free witness, nova.rs:400;
        here the commitment is baked into the circuit like the doc hash)."""
        cs = self.cs
        tt = self.tt
        mc = self.merkle_commitment
        assert mc is not None, "merkle mode needs the commitment at build"
        root = lc_const(mc.commitment % F.Q)
        height = mc.height
        self.merkle_lookup_lcs = []
        for i in range(tt.batch_size):
            lk = cs.input(f"merkle_lookup_{i}")
            is_eps = cs.is_eq(chars[i], lc_const(tt.eps_code))
            expect = cs.ite(is_eps, lc_const(tt.ep_num), cursors[i])
            cs.enforce_eq(lk, expect)
            self.merkle_lookup_lcs.append(lk)
            # leaf level: (idx, char) pair with sibling (w0, w1)
            w0 = cs.input(f"merkle_w0_{i}")
            w1 = cs.input(f"merkle_w1_{i}")
            lr = cs.input(f"merkle_lr_{i}_0")
            cs.assert_bool(lr)
            e0 = cs.ite(lr, lk, w0)
            e1 = cs.ite(lr, chars[i], w1)
            e2 = cs.ite(lr, w0, lk)
            e3 = cs.ite(lr, w1, chars[i])
            h = self._hash_absorb([e0, e1, e2, e3])
            for lvl in range(1, height):
                w = cs.input(f"merkle_w_{i}_{lvl}")
                lrh = cs.input(f"merkle_lr_{i}_{lvl}")
                cs.assert_bool(lrh)
                left = cs.ite(lrh, h, w)
                right = cs.ite(lrh, w, h)
                h = self._hash_absorb([left, right])
            cs.enforce_eq(h, root)
