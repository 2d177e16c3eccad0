"""SAFA — skipping alternating finite automaton.

Mirrors the observable behavior of the reference SAFA
(reference src/frontend/safa.rs): a graph whose nodes are hash-consed
regexes tagged ∀/∃ (Quant) and whose edges are either single characters or
Skip sets (OpenSet over document offsets).  Construction (safa.rs:199-214):
for each new node, first match wins:

  1. extract_skip  -> skip edge + complement-skip edge to the sink,
  2. ∀-fork        -> lookahead conjunctions split into ε-children,
  3. ∃-fork        -> alternations split into ε-children,
  4. derivatives   -> one char edge per alphabet symbol (+ self ε-loop).

The solver (safa.rs:353-492) is a backtracking search producing a Trace; the
reference parallelizes candidate skip offsets with rayon, this implementation
memoizes failed (node, cursor) states instead (same worst-case search space,
sequential host code; a native solver can slot in later).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Set, Tuple

from . import regex as R
from .openset import OpenSet
from .quantifier import Quant
from .trace import (Trace, TraceElem, char_edge, class_edge, epsilon,
                    skip_edge)

Edge = Tuple[str, object]  # ("c", cp) | ("r", OpenSet) | ("s", OpenSet)


class SAFA:
    def __init__(self, alphabet, regex: R.Regex, _build: bool = True,
                 use_skips: bool = True, dual: bool = False):
        """use_skips=False builds the pure derivative automaton (no skip
        edges); dual=True complements: quantifiers at forks swap and
        acceptance flips to non-nullable — see negate().

        alphabet: a string of chars (enumerated alphabet, per-char
        derivative edges — the reference's model) or None for the FULL
        UNICODE alphabet (config.rs:253-263 semantics): consuming edges are
        then range-compressed derivative CLASSES (("r", OpenSet) labels)
        and the alphabet is never enumerated."""
        self.ab = (None if alphabet is None
                   else sorted(ord(c) for c in set(alphabet)))
        self.nodes: List[Quant] = []
        # edges stored per-source in insertion order: (dst, label)
        self.out_edges: List[List[Tuple[int, Edge]]] = []
        self.accepting: Set[int] = set()
        self.sink: Optional[int] = None
        self._use_skips = use_skips
        self._dual = dual
        self._eof_node: Optional[int] = None
        # (regex uid, is_and) -> node index, for find_or_add
        self._index: Dict[Tuple[int, bool], int] = {}
        if _build:
            root = self._add_node(Quant.or_(regex))
            old = sys.getrecursionlimit()
            sys.setrecursionlimit(max(old, 100000))
            try:
                self._add(root)
            finally:
                sys.setrecursionlimit(old)
            if self.sink is None and not dual:
                # the empty-class node is a dead end in the primal
                # automaton; in the DUAL it accepts every suffix and must
                # not be pruned as a sink
                self.sink = self.find(R.empty())

    # ------------------------------------------------------------------
    # graph primitives
    # ------------------------------------------------------------------

    def _add_node(self, q: Quant) -> int:
        idx = len(self.nodes)
        self.nodes.append(q)
        self.out_edges.append([])
        self._index[(q.get().uid, q.is_and)] = idx
        return idx

    def _add_edge(self, src: int, dst: int, label: Edge):
        self.out_edges[src].append((dst, label))

    def exists(self, r: R.Regex, is_and: bool) -> bool:
        return (r.uid, is_and) in self._index

    def find(self, r: R.Regex) -> Optional[int]:
        """First node (by index) holding regex r, either quantifier."""
        best = None
        for key, idx in self._index.items():
            if key[0] == r.uid and (best is None or idx < best):
                best = idx
        return best

    def find_or_add(self, r: R.Regex, is_and: bool) -> int:
        got = self._index.get((r.uid, is_and))
        if got is not None:
            return got
        return self._add_node(Quant(r, is_and))

    # ------------------------------------------------------------------
    # construction (safa.rs:86-221)
    # ------------------------------------------------------------------

    def _add_skip(self, n: int, skip: OpenSet, q_c: R.Regex):
        recurse = not self.exists(q_c, False)
        n_c = self.find_or_add(q_c, False)
        self._add_edge(n, n_c, skip_edge(skip))
        # complement skip always fails -> edge to sink (safa.rs:108-119).
        # In the DUAL automaton the (single-offset) skip {k} complement is
        # "fewer than k characters remain": an edge [0, k-1] to an
        # EOF-ONLY node (accepting with no consuming continuation — the
        # trace accepts iff the jump lands exactly at document end).  An
        # accept-anything target would over-accept (the fuzz caught it),
        # since offsets other than k say nothing about the original's
        # failure when >= k characters remain.
        if not skip.is_full() and not skip.is_nil():
            if self._dual:
                k = skip.is_single()
                assert k is not None and k >= 1, "dual keeps only det skips"
                self._add_edge(n, self._dual_eof_node(),
                               skip_edge(OpenSet.closed(0, k - 1)))
            else:
                if self.sink is None:
                    n_empty = self._add_node(Quant(R.empty(), False))
                    self.sink = n_empty
                    self._add_edge(n_empty, n_empty, epsilon())
                self._add_edge(n, self.sink, skip_edge(skip.negate()))
        if recurse:
            self._add(n_c)

    def _dual_eof_node(self) -> int:
        """Accepting node with every char edge into a dead node: accepts a
        suffix iff it is EMPTY (the complement of 'at least k chars
        remain').  Built outside _index so it can never alias a real
        derivative state."""
        if self._eof_node is None:
            dead = len(self.nodes)
            self.nodes.append(Quant(R.empty(), False))
            self.out_edges.append([(dead, epsilon())])
            eof = len(self.nodes)
            self.nodes.append(Quant(R.nil(), False))
            consuming = ([(dead, class_edge(
                OpenSet.closed(0, R.MAX_CODEPOINT)))]
                if self.ab is None
                else [(dead, char_edge(c)) for c in self.ab])
            self.out_edges.append([(eof, epsilon())] + consuming)
            self.accepting.add(eof)
            self._eof_node = eof
        return self._eof_node

    def _add_derivatives(self, frm: int):
        self._add_edge(frm, frm, epsilon())  # self ε-loop (safa.rs:150)
        r = self.nodes[frm].get()
        if self.ab is None:
            # full-unicode: one range-compressed edge per derivative class
            for lo, hi, q_c in R.deriv_classes(r):
                recurse = not self.exists(q_c, False)
                n_c = self.find_or_add(q_c, False)
                self._add_edge(frm, n_c,
                               class_edge(OpenSet.closed(lo, hi)))
                if recurse:
                    self._add(n_c)
            return
        for c in self.ab:
            q_c = R.deriv(r, c)
            recurse = not self.exists(q_c, False)
            n_c = self.find_or_add(q_c, False)
            self._add_edge(frm, n_c, char_edge(c))
            if recurse:
                self._add(n_c)

    def _add_fork(self, is_and: bool, frm: int) -> bool:
        def to_set(r: R.Regex) -> List[R.Regex]:
            if is_and and r.tag == R.AND:
                return to_set(r.a) + to_set(r.b)
            if not is_and and r.tag == R.ALT:
                return to_set(r.a) + to_set(r.b)
            return [r]

        children = sorted(set(to_set(self.nodes[frm].get())), key=lambda x: x.uid)
        if len(children) > 1:
            # dual automata swap the fork quantifier (AND-splits become
            # exists-forks and vice versa); the SPLIT criterion stays tied
            # to the regex tag
            quant_and = is_and != self._dual
            q = self.nodes[frm]
            self.nodes[frm] = Quant(q.get(), quant_and)
            self._index.pop((q.get().uid, q.is_and), None)
            self._index[(q.get().uid, quant_and)] = frm
            for q_c in children:
                self._add_skip(frm, OpenSet.nil(), q_c)
            return True
        return False

    # bounded skip ranges dualize as for-all forks over this many
    # singleton offsets at most (each child is a deterministic jump);
    # wider ranges fall back to derivative edges
    DUAL_RANGE_FORK_MAX = 16
    # total range-fork budget per build: NESTED counted repeats of range
    # skips multiply fork children per level (fuzz found builds that
    # never finished); past the budget the build falls back to
    # derivative edges, which stay polynomial
    DUAL_RANGE_FORK_BUDGET = 64

    def _add(self, frm: int):
        r = self.nodes[frm].get()
        if R.nullable(r) != self._dual:
            self.accepting.add(frm)
        if self._dual and r == R.empty():
            # the original matches NOTHING from here, so the complement
            # accepts EVERY suffix: jump straight to document end (one
            # skip trace element) instead of walking the rest of the doc
            # char-by-char through the empty-language self-loops — an
            # early mismatch under `-n` was linear in the tail otherwise
            self._add_edge(frm, self._dual_eof_node(),
                           skip_edge(OpenSet.open(0)))
            return
        got = R.extract_skip(r) if self._use_skips else None
        if got is not None and self._dual:
            # DETERMINISTIC skips survive dualization directly: a single
            # offset is a forced jump (self-dual).  A BOUNDED range is an
            # existential choice over finitely many offsets, whose
            # complement is a for-all — representable as a dual AND-fork
            # over the singleton-offset children `.{k}rem` (each of which
            # dualizes deterministically); see _dual_range_fork.  Star
            # skips (unbounded) fall through to derivative edges: their
            # complement quantifies over every remaining offset, which is
            # inherently linear — the derivative walk IS the optimal
            # witness.  Without any of this, negating `^.{500000}MOTIF..`
            # either over-accepted (old accepting-flip) or unrolled 500k
            # derivative states (pure skip-free rebuild).
            single = got[0].is_single()
            if single is None and not got[0].is_nil():
                if self._dual_range_fork(frm, got[0], got[1]):
                    return
                got = None
        if got is not None:
            skip, rem = got
            self._add_skip(frm, skip, rem)
            return
        if self._add_fork(True, frm):
            return
        if self._add_fork(False, frm):
            return
        self._add_derivatives(frm)

    def _dual_range_fork(self, frm: int, skip, rem: R.Regex) -> bool:
        """Dualize a BOUNDED skip range: the original node is an exists
        over offsets k in the range (OR-fork over children `.{k}rem`),
        which the dual build turns into a for-all.  Sound because the
        fork is an exact semantic rewrite of the original node and each
        child carries a deterministic single-offset skip."""
        if not skip.ranges or skip.ranges[-1][1] is None:
            return False                      # open-ended: not bounded
        if getattr(self, "_range_forks", 0) >= self.DUAL_RANGE_FORK_BUDGET:
            return False
        members = []
        for k in skip.iter_bounded(skip.ranges[-1][1]):
            members.append(k)
            if len(members) > self.DUAL_RANGE_FORK_MAX:
                return False
        if len(members) < 2:
            return False
        self._range_forks = getattr(self, "_range_forks", 0) + 1
        q = self.nodes[frm]
        quant_and = self._dual                # original exists -> dual AND
        self.nodes[frm] = Quant(q.get(), quant_and)
        self._index.pop((q.get().uid, q.is_and), None)
        self._index[(q.get().uid, quant_and)] = frm
        for k in members:
            child = R.simpl(R.app(R.range_(R.dot(), k, k), rem))
            self._add_skip(frm, OpenSet.nil(), child)
        return True

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------

    @property
    def init(self) -> int:
        return 0

    def num_states(self) -> int:
        return len(self.nodes)

    def num_edges(self) -> int:
        return sum(len(e) for e in self.out_edges)

    def is_fork(self, n: int) -> bool:
        """All outgoing edges are skip-type (safa.rs:217-221)."""
        return all(lbl[0] == "s" for _, lbl in self.out_edges[n])

    def is_sink(self, n: int) -> bool:
        return self.sink == n

    def non_accepting(self) -> Set[int]:
        return set(range(len(self.nodes))) - self.accepting

    def forall_nodes(self) -> List[int]:
        return [n for n in range(len(self.nodes))
                if self.is_fork(n) and self.nodes[n].is_and]

    def exist_nodes(self) -> List[int]:
        return [n for n in range(len(self.nodes))
                if self.is_fork(n) and self.nodes[n].is_or]

    def max_skip_offset(self) -> int:
        off = 0
        for edges in self.out_edges:
            for _, lbl in edges:
                if lbl[0] == "s":
                    m = lbl[1].max_offset()
                    if m is not None and m > off:
                        off = m
        return off

    def max_forall_fanout(self) -> int:
        best = 0
        for n in self.forall_nodes():
            fan = sum(1 for dst, _ in self.out_edges[n] if dst != n)
            best = max(best, fan)
        return best

    def edges(self, n: int) -> List[Tuple[int, Edge]]:
        """Outgoing edges minus the self ε-loop (safa.rs:382-388)."""
        return [(dst, lbl) for dst, lbl in self.out_edges[n]
                if dst != n or not (lbl[0] == "s" and lbl[1].is_nil())]

    def to_regex(self) -> R.Regex:
        return self.nodes[self.init].get()

    # ------------------------------------------------------------------
    # negation (safa.rs:224-253)
    # ------------------------------------------------------------------

    def negate(self) -> "SAFA":
        """SOUND complement: rebuild from the regex as a SKIP-FREE
        alternating automaton with dualized quantifiers (AND-forks <->
        OR-forks) and complemented acceptance.

        The reference's negate flips the accepting set on the original
        graph (safa.rs:224-253, with the fork dualization commented out
        and double-negation tests #[ignore]d) — over-accepting whenever
        the graph has exists-forks or skip edges, since those encode
        existential choices whose complement is a FOR-ALL (fuzz found
        830/6000 wrong 'non-match' answers on alternation regexes; for a
        proof system, a wrong non-match proof is a soundness break, so we
        diverge).  Skip edges are disabled in the complement because a
        skip's dual is a for-all over document offsets, which the SAFA
        cannot represent: negated queries walk the document char by char
        (correctness over the skip optimization).  In the skip-free
        build every non-fork state is a total deterministic derivative
        state, so dualize-and-flip is the textbook alternating-automaton
        complement.

        Known build-time limitation (pre-existing, independent of the
        range-fork dualization): deeply NESTED counted repeats of range
        skips (e.g. `(?:(?:.{3,7}b){3,6}){3,5}`) explode the derivative
        state space and the build may not terminate in reasonable time —
        in the positive automaton too; this is a property of counted-
        repeat expansion, not of negation."""
        ab_str = (None if self.ab is None
                  else "".join(chr(c) for c in self.ab))
        return SAFA(ab_str, self.to_regex(), use_skips=True,
                    dual=not self._dual)

    # ------------------------------------------------------------------
    # solver (safa.rs:353-492)
    # ------------------------------------------------------------------

    def solve(self, doc: List[int], native: Optional[bool] = None
              ) -> Optional[Trace]:
        """Find a matching trace.  native=None tries the C++ solver for
        large documents and falls back to Python."""
        if native is None:
            native = len(doc) > 4096
        if self.ab is None:
            native = False      # native solver speaks per-char edges only
        if native:
            try:
                from .native_solver import solve_native
                return solve_native(self, doc)
            except RuntimeError:
                pass
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 100000))
        try:
            memo: Dict[Tuple[int, int], bool] = {}
            return self._solve_rec(self.init, 0, doc, memo)
        finally:
            sys.setrecursionlimit(old)

    def _solve_edge(self, lbl: Edge, frm: int, to: int, i: int,
                    doc: List[int], memo) -> Optional[Trace]:
        if lbl[0] in ("c", "r"):
            if self.is_sink(to):
                return None
            if (lbl[1] == doc[i] if lbl[0] == "c"
                    else lbl[1].contains(doc[i])):
                tail = self._solve_rec(to, i + 1, doc, memo)
                if tail is None:
                    return None
                return [TraceElem(frm, lbl, to, i, i + 1)] + tail
            return None
        skip = lbl[1]
        for n in skip.iter_bounded(len(doc) - i):
            tail = self._solve_rec(to, i + n, doc, memo)
            if tail is not None:
                return [TraceElem(frm, lbl, to, i, i + n)] + tail
        return None

    def _solve_rec(self, n: int, i: int, doc: List[int], memo) -> Optional[Trace]:
        if n in self.accepting and i == len(doc):
            return []
        if i >= len(doc) or self.is_sink(n):
            return None
        key = (n, i)
        if memo.get(key, False):
            return None  # known failure
        if self.nodes[n].is_and:
            subs = []
            for dst, lbl in self.out_edges[n]:
                got = self._solve_edge(lbl, n, dst, i, doc, memo)
                if got is None:
                    memo[key] = True
                    return None
                subs.append(got)
            subs.sort(key=lambda t: [e.sort_key() for e in t])
            out: Trace = []
            for t in subs:
                out.extend(t)
            return out
        for dst, lbl in self.edges(n):
            got = self._solve_edge(lbl, n, dst, i, doc, memo)
            if got is not None:
                return got
        memo[key] = True
        return None

    # ------------------------------------------------------------------
    # projection (safa.rs:447-492)
    # ------------------------------------------------------------------

    def _projection_rec(self, n: int, m: OpenSet, visited: Set[int]) -> OpenSet:
        if n in visited:
            return m
        v = visited | {n}
        acc = m
        for dst, lbl in self.out_edges[n]:
            if lbl[0] != "s":
                continue
            s = lbl[1]
            if s.is_nullable() or s.is_open():
                continue
            if self.nodes[n].is_and:
                acc = self._projection_rec(dst, acc.intersection(s), v)
            else:
                acc = self._projection_rec(dst, acc.union(s), v)
        return acc

    def projection(self) -> Optional[int]:
        """Length of the document prefix the regex provably ignores."""
        s = self._projection_rec(self.init, OpenSet.empty(), set())
        f = s.first()
        return f[0] if f is not None else None


def write_dot(safa: SAFA, filename: str) -> str:
    """Write a Graphviz .dot of the SAFA; converts to PDF if `dot` exists
    (the reference's plot feature, safa.rs:494-526)."""
    import subprocess

    lines = ["digraph safa {"]
    for i, q in enumerate(safa.nodes):
        mark = " ✓" if i in safa.accepting else ""
        quant = "∀ " if q.is_and else "∃ "
        label = (quant + repr(q.get()) + mark).replace('"', "'")
        lines.append(f'  n{i} [label="{i}: {label}"];')
    for src in range(len(safa.nodes)):
        for dst, lbl in safa.out_edges[src]:
            if lbl[0] == "c":
                text = chr(lbl[1]) if 32 <= lbl[1] < 127 else hex(lbl[1])
            elif lbl[0] == "r":
                text = "r" + repr(lbl[1])
            else:
                text = repr(lbl[1])
            text = text.replace('"', "'")
            lines.append(f'  n{src} -> n{dst} [label="{text}"];')
    lines.append("}")
    dot_path = filename + ".dot"
    with open(dot_path, "w") as fh:
        fh.write("\n".join(lines))
    try:
        subprocess.run(["dot", "-Tpdf", dot_path, "-o", filename + ".pdf"],
                       check=True, capture_output=True)
        return filename + ".pdf"
    except (FileNotFoundError, subprocess.CalledProcessError):
        return dot_path


def equiv_upto_epsilon(got: Optional[Trace], want: Trace) -> bool:
    """Trace equality modulo ε-steps (the reference's test helper,
    safa.rs:538)."""
    if got is None:
        return False
    g = [e for e in got if not e.is_nil()]
    w = [e for e in want if not e.is_nil()]
    return g == w
