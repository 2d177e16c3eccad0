"""Per-batch witness generation: trace -> step-circuit inputs.

Re-implements the reference's gen_wit_i / wit_nlookup_gadget / padding rules
(reference src/backend/r1cs.rs:1609-2393) against the direct-wired step
circuit: per-step transition rows (chars/states/offsets/rels/cursors), stack
push/pop bookkeeping, EOF/EPSILON padding including forall alignment
("wasted" slots), doc accesses, and the host-side nlookup sumcheck proofs.

Simplifications relative to the reference: trace edges carry their labels, so
lo/hi windows come straight from the trace element instead of re-scanning the
graph; stack version/pointer wires don't exist (the circuit derives them), so
only `forall_0_kid_*` and `cursor_popped` are supplied.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..ops import field as F
from ..utils.metrics import count, span
from . import routes
from .step_circuit import StepCircuit
from .sumcheck import nlookup_prove
from .table import TransitionTable, trace_preprocessing


class BatchResult:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class WitnessGenerator:
    def __init__(self, tt: TransitionTable, circuit: StepCircuit,
                 doc_commit_hash: int, hash_salt: int,
                 merkle_commitment=None):
        self.tt = tt
        self.circuit = circuit
        self.doc_hash = doc_commit_hash
        self.salt = hash_salt
        self.merkle_commitment = merkle_commitment
        self.sol_num = 0
        self.stack: List[Tuple[int, int]] = [(0, tt.kid_padding)
                                             for _ in range(tt.max_stack)]
        self.stack_ptr = 0
        self.wasted = 0

    # ------------------------------------------------------------------

    def _edge_window(self, el) -> Tuple[int, int]:
        """(lo, hi) for a trace element (edge_v's window selection,
        r1cs.rs:1774-1840)."""
        tt = self.tt
        if el.consumes:
            return 1, 1
        skip = el.edge[1]
        offs = el.to_cur - el.from_cur
        windows = tt._skip_rows(skip)
        for lo, hi in windows:
            real_hi = float("inf") if hi == tt.star_offset else hi
            if lo <= offs <= real_hi:
                return lo, hi
        return windows[-1]

    def _rel_for(self, state_i: int, next_state: int, trans: bool) -> int:
        tt = self.tt
        if state_i == tt.exit_state:
            return 0
        kids = tt.foralls_w_kids.get(state_i, [])
        return tt.calc_rel(state_i, next_state, kids, trans)

    # ------------------------------------------------------------------

    def gen_batch(self, sols, batch_num: int, in_state: int,
                  running: Dict, cursor_0: int) -> Tuple[Dict[str, int],
                                                         BatchResult]:
        """Build the input assignment for one folding step.

        `running` holds prev running claims: keys nl_q, nl_v, doc_q, doc_v,
        hyb_q, hyb_v (None on batch 0)."""
        tt = self.tt
        bs = tt.batch_size
        wits: Dict[str, int] = {}
        f = F.FQ

        state_i = in_state
        next_state = in_state
        cursor_i = cursor_0
        cursor_access: List[int] = []
        rows_q: List[int] = []
        rows_v: List[int] = []

        wits["cursor_in"] = cursor_0
        wits["step_i"] = batch_num
        wits["hash_salt"] = self.salt

        kids_wit = [tt.kid_padding] * tt.max_branches
        cursor_popped = cursor_0
        did_stack_op = False

        def put_row(i, char_num, s, s2, lo, hi, offset, rel, cur_after,
                    c_lo=None, c_hi=None):
            """c_lo/c_hi: the matched row's char-class bounds; default the
            exact char (per-char edges + EOF/EPSILON rows)."""
            if c_lo is None:
                c_lo = c_hi = char_num
            wits[f"char_{i}"] = char_num
            wits[f"char_lo_{i}"] = c_lo
            wits[f"char_hi_{i}"] = c_hi
            wits[f"state_{i+1}"] = s2
            if i == 0:
                wits.setdefault("state_0", s)
            wits[f"lower_offset_{i}"] = lo
            wits[f"upper_offset_{i}"] = hi
            wits[f"offset_{i}"] = offset
            wits[f"rel_{i}"] = rel
            wits[f"cursor_{i+1}"] = cur_after
            v = tt.encode(rel, s, s2, c_lo, c_hi, lo, hi)
            assert v in tt.row_index, (
                f"row not in table: rel={rel} {s}->{s2} c={char_num} "
                f"[{c_lo},{c_hi}] lo={lo} hi={hi}")
            rows_v.append(v)
            rows_q.append(tt.row_index[v])

        i = 0
        while i < bs:
            if self.sol_num >= len(sols):
                # all done: pad with EOF rows at the exit state
                state_i = next_state
                cursor_access.append(cursor_i)
                put_row(i, tt.eof_code, state_i, next_state, 0, 0, 0,
                        self._rel_for(state_i, next_state, False), cursor_i)
                self.wasted += 1
                i += 1
                continue

            if not sols[self.sol_num]:
                # transition between solution segments (EOF pop/finish)
                if self.sol_num + 1 == len(sols):
                    next_state = tt.exit_state
                else:
                    next_state = sols[self.sol_num + 1][0].from_node
                cursor_access.append(cursor_i)
                put_row(i, tt.eof_code, state_i, next_state, 0, 0, 0,
                        self._rel_for(state_i, next_state, True), cursor_i)
                i += 1
                self.sol_num += 1
                state_i = next_state
                continue

            te = sols[self.sol_num][0]
            from_is_forall = (self.tt.safa.nodes[te.from_node].is_and
                              and self.tt.safa.is_fork(te.from_node))
            if from_is_forall:
                if i != 0:
                    # align the forall op to batch position 0: pad out
                    while i < bs:
                        state_i = next_state
                        cursor_access.append(tt.ep_num)
                        put_row(i, tt.eps_code, state_i, next_state, 0, 0, 0,
                                self._rel_for(state_i, next_state, False),
                                cursor_i)
                        self.wasted += 1
                        i += 1
                    break
                kids = tt.foralls_w_kids[te.from_node]
                if kids[0] == te.to_node:
                    # push branch: kids[1:] reversed go on the stack
                    did_stack_op = True
                    push_list = list(reversed(kids[1:]))
                    for b, kid in enumerate(push_list):
                        self.stack[self.stack_ptr] = (cursor_i, kid)
                        self.stack_ptr += 1
                        kids_wit[b] = kid
                else:
                    # pop branch
                    did_stack_op = True
                    self.stack_ptr -= 1
                    pc, pk = self.stack[self.stack_ptr]
                    assert pk == te.to_node, (pk, te.to_node)
                    cursor_popped = pc
                    cursor_i = pc

            sols[self.sol_num].pop(0)
            c_lo = c_hi = None
            if te.is_char:
                char_num = tt.num_ab[te.edge[1]]
            elif te.is_class:
                # range-class edge: the consumed char comes from the doc;
                # the row is the class range containing it
                char_num = tt.udoc[cursor_i]
                for a, b in te.edge[1].ranges:
                    if a <= char_num <= (b if b is not None else char_num):
                        c_lo, c_hi = a, b
                        break
                assert c_lo is not None, "consumed char outside edge class"
            else:
                char_num = tt.eps_code
            cursor_access.append(tt.ep_num if char_num == tt.eps_code
                                 else cursor_i)
            state_i = te.from_node
            next_state = te.to_node
            offset = te.to_cur - te.from_cur
            cursor_i += offset
            lo, hi = self._edge_window(te)
            put_row(i, char_num, state_i, next_state, lo, hi, offset,
                    self._rel_for(state_i, next_state, False), cursor_i,
                    c_lo, c_hi)
            i += 1
            state_i = next_state

        for b in range(tt.max_branches):
            wits[f"forall_0_kid_{b}"] = kids_wit[b]
        wits["cursor_popped"] = cursor_popped
        wits.setdefault("state_0", in_state)

        # ---------------- doc accesses -----------------------------------
        idoc = tt.udoc
        ds0 = tt.doc_subset[0] if tt.doc_subset else 0
        doc_q = [a - ds0 for a in cursor_access]
        doc_v = [idoc[a] for a in cursor_access]
        proj_doc = (idoc[tt.doc_subset[0]:tt.doc_subset[1]]
                    if tt.doc_subset else idoc)

        result = BatchResult(next_state=next_state, next_cursor=cursor_i,
                             sp_out=self.stack_ptr,
                             stack_out=[c * tt.num_states + k
                                        for c, k in self.stack],
                             merkle_lookups=None)

        # ---------------- nlookup proofs ----------------------------------
        mode = self.circuit.mode
        if mode == "merkle":
            self._fill_nl(wits, "nl", tt.table, rows_q, rows_v,
                          running.get("nl_q"), running.get("nl_v"), None,
                          result)
            mc = self.merkle_commitment
            for i2 in range(bs):
                wits[f"merkle_lookup_{i2}"] = doc_q[i2]
                path = mc.path_wits(doc_q[i2])
                wits[f"merkle_w0_{i2}"] = path[0].opposite_idx or 0
                wits[f"merkle_w1_{i2}"] = path[0].opposite
                wits[f"merkle_lr_{i2}_0"] = int(path[0].l_or_r)
                for lvl in range(1, mc.height):
                    wits[f"merkle_w_{i2}_{lvl}"] = path[lvl].opposite
                    wits[f"merkle_lr_{i2}_{lvl}"] = int(path[lvl].l_or_r)
            result.merkle_lookups = doc_q
        elif mode == "hybrid":
            half = tt.hybrid_len // 2
            hybrid_table = list(tt.table)
            while len(hybrid_table) < tt.hybrid_len:
                hybrid_table.extend(proj_doc)
                pad = ((1 << (len(proj_doc) - 1).bit_length())
                       if len(proj_doc) > 1 else 1) - len(proj_doc)
                hybrid_table.extend([0] * max(0, pad))
            hybrid_table = hybrid_table[:tt.hybrid_len]
            hq = rows_q + [q + half for q in doc_q]
            hv = rows_v + doc_v
            self._fill_nl(wits, "nlhybrid", hybrid_table, hq, hv,
                          running.get("hyb_q"), running.get("hyb_v"),
                          self.doc_hash, result, attr="hyb")
            wits["nlhybrid_prev_running_claim"] = (
                running["hyb_v"] if running.get("hyb_v") is not None
                else hybrid_table[0] % f.p)
        else:
            self._fill_nl(wits, "nl", tt.table, rows_q, rows_v,
                          running.get("nl_q"), running.get("nl_v"), None,
                          result)
            self._fill_nl(wits, "nldoc", proj_doc, doc_q, doc_v,
                          running.get("doc_q"), running.get("doc_v"),
                          self.doc_hash, result, attr="doc")
            wits["nldoc_prev_running_claim"] = (
                running["doc_v"] if running.get("doc_v") is not None
                else proj_doc[0] % f.p)

        return wits, result

    def _maybe_device_cache(self, tag: str, table):
        """Device table cache for the sumcheck hot loop, where
        backend/routes.py routes a table of len(table) entries: split over
        the process mesh (`mesh.table_cache`: a power of two of devices,
        at least 2 entries each, else whole on the lead), or whole on the
        card; None on the host.  A failed kernel build or launch raises:
        the route never falls back to the host behind the caller's
        back."""
        if not hasattr(self, "_dev_caches"):
            self._dev_caches = {}
        key = (tag, len(table))
        if key in self._dev_caches:
            count("Solver", "device_cache_hit")
            return self._dev_caches[key]
        count("Solver", "device_cache_miss")
        on = routes.route("sumcheck", len(table))
        cache = None
        if on != routes.HOST:
            from ..ops.limb import FQ as LFQ
            from ..ops.sumcheck_device import DeviceTableCache
            from ..parallel.mesh import process_mesh, table_cache
            cache = (table_cache(LFQ, table, process_mesh())
                     if on == routes.MESH else DeviceTableCache(LFQ, table))
            count("Solver", "nl_table_card")
        self._dev_caches[key] = cache
        return cache

    def _maybe_host_cache(self, tag: str, table):
        """Padded Montgomery-domain copy of a (constant) lookup table,
        built once per run: each nlookup batch clones it with a memcpy
        instead of re-converting len(table) python ints (the dominant cost
        at 1 MB docs: the doc table alone is 2^20 conversions per fold)."""
        from ..ops import native_fieldvec as FV
        if not FV.available() or len(table) < (1 << 10):
            return None
        if not hasattr(self, "_host_caches"):
            self._host_caches = {}
        key = (tag, len(table))
        cache = self._host_caches.get(key)
        if cache is None:
            p = F.FQ.p
            if p not in FV.FIELD_ID:
                return None
            sc_l = max(1, (len(table) - 1).bit_length())
            sct = [t % p for t in table]
            sct.extend([0] * ((1 << sc_l) - len(sct)))
            cache = FV.MontTable(sct, p)
            count("Solver", "nl_table_host")
            self._host_caches[key] = cache
        return cache

    def _fill_nl(self, wits, tag: str, table, qs, vs, prev_q, prev_v,
                 doc_hash, result, attr: str = "nl"):
        f = F.FQ
        # the table as the route reads it: a device cache on the card or
        # the mesh, else (on the host) the host cache
        with span("Solver", "nl_table"):
            device_cache = self._maybe_device_cache(tag, table)
            host_cache = (self._maybe_host_cache(tag, table)
                          if device_cache is None else None)
        proof = nlookup_prove(
            f, table, qs, vs, prev_q, prev_v, tag, doc_hash,
            device_cache=device_cache, host_cache=host_cache)
        sc_l = len(proof.sc_rs)
        for i, q in enumerate(qs):
            for j in range(sc_l):
                wits[f"{tag}_eq_{i}_q_{j}"] = (q >> (sc_l - 1 - j)) & 1
        for j, (xsq, x, con) in enumerate(proof.g_coeffs):
            wits[f"{tag}_sc_g_{j+1}_xsq"] = xsq
            wits[f"{tag}_sc_g_{j+1}_x"] = x
            wits[f"{tag}_sc_g_{j+1}_const"] = con
        wits[f"{tag}_next_running_claim"] = proof.next_running_v
        if tag == "nl":
            wits["nl_prev_running_claim"] = (prev_v if prev_v is not None
                                             else table[0] % f.p)
        setattr(result, f"{attr}_next_q", proof.next_running_q)
        setattr(result, f"{attr}_next_v", proof.next_running_v)


def solve_and_batch(tt: TransitionTable, circuit: StepCircuit,
                    doc_codes: List[int], doc_commit_hash: int,
                    hash_salt: int, merkle_commitment=None):
    """Generator over batches: yields (wits, z_in, result) per fold step.

    This is the host side of the reference's solver thread loop
    (framework.rs:354-640)."""
    f = F.FQ
    trace = tt.safa.solve(doc_codes)
    if trace is None:
        raise ValueError("No solution found")
    sols = trace_preprocessing(trace)
    gen = WitnessGenerator(tt, circuit, doc_commit_hash, hash_salt,
                           merkle_commitment)

    running: Dict = {}
    state = 0
    cursor = 0
    sp = 0
    stack = [tt.kid_padding] * tt.max_stack
    batch = 0
    sc_l, doc_l = circuit.sc_l, circuit.doc_l

    while gen.sol_num < len(sols):
        # z_in for this batch
        z_in: Dict[str, int] = {"state_0": state, "stack_ptr_in": sp,
                                "cursor_in": cursor}
        for i, s in enumerate(stack):
            z_in[f"stack_in_{i}"] = s
        if circuit.mode == "split":
            pq = running.get("nl_q") or [0] * sc_l
            for j in range(sc_l):
                z_in[f"nl_run_q_{j}"] = pq[j]
            dq = running.get("doc_q") or [0] * doc_l
            for j in range(doc_l):
                z_in[f"nldoc_run_q_{j}"] = dq[j]
            dv_for_hash = running.get("doc_v") if batch > 0 else 0
            z_in["doc_v_hash_in"] = StepCircuit._hide_host(
                dv_for_hash or 0, hash_salt)
        elif circuit.mode == "hybrid":
            hq = running.get("hyb_q") or [0] * circuit.hyb_l
            for j in range(circuit.hyb_l):
                z_in[f"nlhybrid_run_q_{j}"] = hq[j]
            hv_for_hash = running.get("hyb_v") if batch > 0 else tt.table[0]
            z_in["hyb_v_hash_in"] = StepCircuit._hide_host(
                hv_for_hash % f.p, hash_salt)
        else:
            pq = running.get("nl_q") or [0] * sc_l
            for j in range(sc_l):
                z_in[f"nl_run_q_{j}"] = pq[j]

        wits, res = gen.gen_batch(sols, batch, state, running, cursor)
        wits.update(z_in)

        yield wits, res

        state = res.next_state
        cursor = res.next_cursor
        sp = res.sp_out
        stack = res.stack_out
        running["nl_q"] = getattr(res, "nl_next_q", None)
        running["nl_v"] = getattr(res, "nl_next_v", None)
        running["doc_q"] = getattr(res, "doc_next_q", None)
        running["doc_v"] = getattr(res, "doc_next_v", None)
        running["hyb_q"] = getattr(res, "hyb_next_q", None)
        running["hyb_v"] = getattr(res, "hyb_next_v", None)
        batch += 1
