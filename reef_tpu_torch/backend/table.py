"""SAFA -> transition lookup table T + document transform.

Re-implements the table-generation half of the reference's R1CS::new
(reference src/backend/r1cs.rs:70-546) and its helpers
(normal_add_table, calc_rel: r1cs_helper.rs:88-405), plus doc_transform
(framework.rs:978-1011) and trace_preprocessing (r1cs_helper.rs:65-86).

Each table row encodes one legal transition as the mixed-radix value

    v = rel*S^2*C^2*O^2 + in*S*C^2*O^2 + out*C^2*O^2
        + char_lo*C*O^2 + char_hi*O^2 + lo*O + hi

with S = num_states (SAFA nodes + kid-padding sentinel + exit state),
C = |alphabet| + 2 (EPSILON, EOF codes; 0x110002 for the full-unicode
alphabet), O = max_offsets.  Per-char edges carry char_lo == char_hi;
full-unicode derivative-CLASS edges carry a whole codepoint range per row,
range-checked in-circuit against the doc char (the reference's per-char
edge model cannot enumerate unicode; the encoding generalizes it — a
per-char row is just a width-1 range).  rel codes:
0 normal, 1 transition (accepting -> forall/exit after EOF), 2 out-state
accepting, 3 forall pop branch, >=4 forall push with the kid list hashed in
base S (r1cs_helper.rs:362-405).

Deviations from the reference (all self-consistent; the verifier re-derives
the table with this same code):
  - accepting->exit backtrace rows are added for EVERY forall kid path, not
    only the last kid of the last forall (the reference's choice depends on
    FxHashMap iteration order; being generous makes every solver trace
    encodable);
  - sub-DFS passes never emit rows for forall-source edges (those are added
    exactly once in the forall pass with the correct kid hash).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple  # noqa: F401

from ..frontend.safa import SAFA
from . import costs

EOF_CHAR = 26  # ASCII SUB, the reference's EOF sentinel (r1cs.rs:99)


def _has_cycle(edges) -> bool:
    """True iff the directed edge list contains a cycle (Kahn's algorithm;
    used on the char-consuming edges of a SAFA subgraph — a preorder
    back-edge test misfires on DAG cross edges, e.g. alternation branches
    converging on a shared suffix state)."""
    from collections import defaultdict
    out = defaultdict(list)
    indeg = defaultdict(int)
    nodes = set()
    for a, b in edges:
        out[a].append(b)
        indeg[b] += 1
        nodes.add(a)
        nodes.add(b)
    queue = [n for n in nodes if indeg[n] == 0]
    seen = 0
    while queue:
        n = queue.pop()
        seen += 1
        for m in out[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                queue.append(m)
    return seen != len(nodes)


class _UnicodeAB:
    """Identity codepoint -> index map for the full-unicode alphabet
    (the alphabet is never enumerated; indices ARE codepoints), with the
    reference's chr(26)-is-EOF quirk mirrored."""

    def __init__(self, n: int, eof_code: int):
        self.n = n
        self._eof = eof_code

    def __contains__(self, c: int) -> bool:
        return 0 <= c < self.n

    def __getitem__(self, c: int) -> int:
        if c == EOF_CHAR:
            return self._eof
        if not (0 <= c < self.n):
            raise KeyError(c)
        return c


def make_num_ab(ab_codes: Optional[List[int]]
                ) -> Tuple[Dict[int, int], int, int, int]:
    """codepoint -> char index map, plus (eps_code, eof_code, num_chars).

    Mirrors r1cs.rs:92-99 including the quirks: index |ab| is unused
    (EPSILON = |ab|+1, EOF = |ab|+2), num_chars = |ab|+2, and chr(26) in the
    alphabet is overridden to the EOF code.  ab_codes=None selects the
    full-unicode alphabet (identity map over 0..0x10FFFF).
    """
    if ab_codes is None:
        n = 0x110000
        eps_code = n + 1
        eof_code = n + 2
        return _UnicodeAB(n, eof_code), eps_code, eof_code, n + 2
    num_ab = {}
    for i, c in enumerate(ab_codes):
        num_ab[c] = i
    n = len(ab_codes)
    eps_code = n + 1
    eof_code = n + 2
    num_ab[EOF_CHAR] = eof_code
    num_chars = n + 2
    return num_ab, eps_code, eof_code, num_chars


def doc_transform(ab_codes: Optional[List[int]],
                  doc: List[int]) -> List[int]:
    """Document chars -> usize codes + EOF + EPSILON, zero-padded to 2^k.
    ab_codes=None: the full-unicode alphabet (codes are codepoints)."""
    num_ab, eps_code, eof_code, _ = make_num_ab(ab_codes)
    udoc = []
    for c in doc:
        if c not in num_ab:
            raise ValueError("Character in document that's not in alphabet")
        udoc.append(num_ab[c])
    udoc.append(eof_code)
    udoc.append(eps_code)
    ext = (1 << costs.logmn(len(udoc))) - len(udoc)
    udoc.extend([0] * ext)
    return udoc


def trace_preprocessing(trace) -> List[list]:
    """Split the solver trace at state discontinuities (pop-backs)."""
    sols: List[list] = []
    cur: list = []
    state_i = 0
    for e in trace:
        if state_i != e.from_node and cur:
            sols.append(cur)
            cur = []
        cur.append(e)
        state_i = e.to_node
    sols.append(cur)
    return sols


class TransitionTable:
    """The compiled lookup table + all circuit-shape parameters."""

    def __init__(self, safa: SAFA, udoc: Optional[List[int]], udoc_len: int,
                 orig_doc_len: int, batch_size: int = 0,
                 projection: Optional[int] = None, hybrid: bool = False,
                 merkle: bool = False):
        assert udoc_len > 0 and (udoc_len & (udoc_len - 1)) == 0
        if udoc is not None:
            assert len(udoc) == udoc_len
        self.safa = safa
        self.udoc = udoc
        self.udoc_len = udoc_len
        self.orig_doc_len = orig_doc_len
        self.merkle = merkle

        self.num_ab, self.eps_code, self.eof_code, self.num_chars = \
            make_num_ab(safa.ab)

        n = safa.num_states()
        self.kid_padding = n
        self.exit_state = n + 1
        self.num_states = n + 2

        self.max_offsets = max(safa.max_skip_offset(), 1) + 2
        self.star_offset = self.max_offsets - 1
        self.max_branches = max(safa.max_forall_fanout(), 1)

        self.ep_num = orig_doc_len + 1

        self._build_table()
        self._setup_projection(projection, hybrid)
        self._setup_hybrid(hybrid)

        if batch_size == 0:
            self.batch_size = costs.opt_cost_model_select(
                safa.num_states(), safa.num_edges(), udoc_len, hybrid,
                self.hybrid_len, projection is not None, self.max_offsets,
                self.max_branches, self.max_stack, self.path_lens,
                self.num_chars)
        else:
            self.batch_size = batch_size
        assert self.batch_size > 1
        assert not (merkle and (self.hybrid_len is not None
                                or self.doc_subset is not None))

        # row value -> table index, for witness lookups
        self.row_index = {v: i for i, v in enumerate(self.table)}

    # ------------------------------------------------------------------

    def encode(self, rel: int, in_state: int, out_state: int, c_lo: int,
               c_hi: int, lo: int, hi: int) -> int:
        S, C, O = self.num_states, self.num_chars, self.max_offsets
        # The in-circuit digit pinning (step_circuit.py lookup encodings)
        # relies on every table row satisfying 0 <= c_lo <= c_hi <= C:
        # it makes the base-C decomposition of the char portion unique.
        assert 0 <= c_lo <= c_hi <= C, (rel, in_state, out_state, c_lo, c_hi)
        return (rel * S * S * C * C * O * O + in_state * S * C * C * O * O
                + out_state * C * C * O * O + c_lo * C * O * O
                + c_hi * O * O + lo * O + hi)

    def calc_rel(self, in_state: int, out_state: int, children: List[int],
                 trans: bool) -> int:
        """rel-code semantics (r1cs_helper.rs:362-405)."""
        if trans:
            return 1
        if self.safa.nodes[in_state].is_and and self.safa.is_fork(in_state):
            if children and children[0] == out_state:
                rel = 4
                S = self.num_states
                L = len(children)
                for k in range(1, L):
                    rel += children[L - k] * (S ** k)
                for k in range(L, self.max_branches + 1):
                    rel += self.kid_padding * (S ** k)
                return rel
            return 3
        if out_state in self.safa.accepting:
            return 2
        return 0

    # ------------------------------------------------------------------

    def _skip_rows(self, skip) -> List[Tuple[int, int]]:
        """(lo, hi) encodings for a skip set (one per range; * -> star)."""
        single = skip.is_single()
        if single is not None:
            return [(single, single)]
        if skip.is_full():
            return [(0, self.star_offset)]
        out = []
        for s, e in skip.ranges:
            out.append((s, self.star_offset if e is None else e))
        return out

    def _dfs(self, start: int, stop_at_forall: bool):
        """Preorder DFS node order from start (insertion-order edges)."""
        seen = {start}
        order = []
        stack = [start]
        while stack:
            node = stack.pop()
            order.append(node)
            if stop_at_forall and node != start and \
                    self.safa.nodes[node].is_and and self.safa.is_fork(node):
                continue
            for dst, _ in reversed(self.safa.out_edges[node]):
                if dst not in seen:
                    seen.add(dst)
                    stack.append(dst)
        return order

    def _add_path_rows(self, rows: set, start: int, backtrace_state: int,
                       children: List[int], also_exit: bool) -> int:
        """Add rows for the subgraph reachable from `start`
        (the reference's normal_add_table, r1cs_helper.rs:88-360).

        Returns a trace-length estimate for the cost model: the DFS node
        count, EXCEPT when the subgraph contains a char-consuming cycle
        (e.g. the a* loop of an anchored `^a*b$`) and no skip edge — then
        the solver may consume the document one char per step and the
        estimate is udoc_len (all inputs public, so the verifier derives
        the same batch size).  Skip-capable subgraphs resolve in ~node
        count steps regardless of doc size (Reef's headline trick), so
        they keep the small estimate."""
        safa = self.safa
        order = self._dfs(start, stop_at_forall=False)
        in_sub = set(order)
        has_skip = False
        char_edges = []                 # consuming edges inside the subgraph
        for state in order:
            is_forall = safa.nodes[state].is_and and safa.is_fork(state)
            if not is_forall:
                for dst, lbl in safa.out_edges[state]:
                    if safa.is_sink(dst):
                        continue
                    rel = self.calc_rel(state, dst, children, False)
                    if lbl[0] == "c":
                        c = self.num_ab[lbl[1]]
                        rows.add(self.encode(rel, state, dst, c, c, 1, 1))
                        if dst in in_sub:
                            char_edges.append((state, dst))
                    elif lbl[0] == "r":
                        for a, b in lbl[1].ranges:
                            assert b is not None, "char classes are closed"
                            rows.add(self.encode(rel, state, dst, a, b,
                                                 1, 1))
                        if dst in in_sub:
                            char_edges.append((state, dst))
                    else:
                        if not lbl[1].is_nil():    # ε self-loops aren't
                            has_skip = True        # document jumps
                        for lo, hi in self._skip_rows(lbl[1]):
                            rows.add(self.encode(rel, state, dst,
                                                 self.eps_code,
                                                 self.eps_code, lo, hi))
            if state in safa.accepting:
                # backtrace after EOF (pop to forall, or finish at exit)
                rel = self.calc_rel(state, backtrace_state, children, True)
                rows.add(self.encode(rel, state, backtrace_state,
                                     self.eof_code, self.eof_code, 0, 0))
                if also_exit and backtrace_state != self.exit_state:
                    rows.add(self.encode(
                        self.calc_rel(state, self.exit_state, children, True),
                        state, self.exit_state, self.eof_code,
                        self.eof_code, 0, 0))
        if not has_skip and _has_cycle(char_edges):
            return max(len(order) + 1, self.udoc_len + 1)
        return len(order) + 1

    def _build_table(self):
        safa = self.safa
        rows: set = set()
        self.foralls_w_kids: Dict[int, List[int]] = {}
        self.max_stack = 1
        max_rel = 1

        # pass 1: forall nodes (epsilon loop + kid edges with push/pop rels)
        for state in self._dfs(0, stop_at_forall=False):
            if safa.nodes[state].is_and and safa.is_fork(state):
                kids = sorted(dst for dst, _ in safa.out_edges[state]
                              if dst != state)
                self.foralls_w_kids[state] = kids
                rel = self.calc_rel(state, state, kids, False)
                max_rel = max(max_rel, rel)
                rows.add(self.encode(rel, state, state, self.eps_code,
                                     self.eps_code, 0, 0))
                for kid in kids:
                    rel = self.calc_rel(state, kid, kids, False)
                    max_rel = max(max_rel, rel)
                    rows.add(self.encode(rel, state, kid, self.eps_code,
                                         self.eps_code, 0, 0))

        # pass 2: per-kid subgraph paths (backtrace to their forall + exit)
        self.path_lens: List[int] = []
        for forall, kids in self.foralls_w_kids.items():
            for kid in kids:
                plen = self._add_path_rows(rows, kid, forall, kids,
                                           also_exit=True)
                self.path_lens.append(plen)
            self.max_stack += len(kids)

        # pass 3: initial path from the root up to the first foralls
        plen = self._add_path_rows(rows, 0, self.exit_state, [],
                                   also_exit=False)
        self.path_lens.append(plen)

        # exit-state EOF self-loop
        rows.add(self.encode(0, self.exit_state, self.exit_state,
                             self.eof_code, self.eof_code, 0, 0))

        table = sorted(rows)
        self.max_rel = max_rel
        # pad to a power of two with an out-of-range fill value
        S, C, O = self.num_states, self.num_chars, self.max_offsets
        calc_fill = (max_rel * S * S * C * C * O * O + S * S * C * C * O * O
                     + S * C * C * O * O + C * C * O * O + C * O * O
                     + O * O + O)
        while len(table) < (1 << costs.logmn(len(table))):
            table.append(calc_fill)
        self.table = table
        self.calc_fill = calc_fill

    # ------------------------------------------------------------------

    def _setup_projection(self, projection: Optional[int], hybrid: bool):
        """Choose the power-of-2 document chunk to prove against
        (r1cs.rs:410-471)."""
        self.doc_subset: Optional[Tuple[int, int]] = None
        self.proj_chunk_idx: Optional[List[int]] = None
        if projection is None:
            return
        full = costs.next_power_of_two(self.udoc_len)
        if full <= len(self.table) and hybrid:
            raise ValueError(
                "Doc len <= table size already; projections AND hybrid not "
                "useful together, choose one.")
        real_start = projection
        chunk_len = full // 2
        e, s = full, 0
        end, start = e, 0
        # NB: the chunk must cover the EOF (orig_len) and EPSILON (orig_len+1)
        # sentinel positions the witness reads; the reference's bound
        # (e >= orig_doc_len, r1cs.rs:436) lets those fall outside the chunk.
        min_end = self.orig_doc_len + 2
        while e >= min_end:
            end, start = e, s
            s = 0
            while s + chunk_len <= real_start:
                s += chunk_len
            e = s + chunk_len
            assert end <= full
            chunk_len //= 2
        chunk_len = end - start
        assert chunk_len == costs.next_power_of_two(chunk_len)
        assert start <= real_start and end >= min_end
        assert start % chunk_len == 0
        if (end - start < len(self.table)) and hybrid:
            start = end - len(self.table)
        if start == 0:
            return
        num_chunks = full // chunk_len
        chunk_idx = start // chunk_len
        bits = []
        for _ in range(costs.logmn(num_chunks)):
            bits.append(chunk_idx % 2)
            chunk_idx >>= 1
        self.proj_chunk_idx = list(reversed(bits))
        self.doc_subset = (start, end)

    def _setup_hybrid(self, hybrid: bool):
        self.hybrid_len: Optional[int] = None
        if not hybrid:
            return
        pub_len = len(self.table)
        if self.doc_subset is not None:
            priv_len = self.doc_subset[1] - self.doc_subset[0]
        else:
            priv_len = self.udoc_len
        half_len = costs.next_power_of_two(max(pub_len, priv_len))
        self.table.extend([self.calc_fill] * (half_len - len(self.table)))
        self.hybrid_len = half_len * 2

    # ------------------------------------------------------------------

    def doc_len(self) -> int:
        if self.doc_subset is not None:
            return self.doc_subset[1] - self.doc_subset[0]
        return costs.next_power_of_two(self.udoc_len)
