"""The step circuit's soundness checks and the negated automaton's skips,
the port held to the JAX package on the CPU.

The seven tampers of tests/test_soundness_fixes.py go through the port's
`backend/step_circuit.py`, `table.py` and `witness.py` `solve_and_batch`
and through the reference's, on the same regex, alphabet and document:
both circuits have the same constraint and wire counts and the same
honest witness, and the same tamper of the same named wire makes
`compiled.check_all` return the same failing constraint in both.

The seven tests of tests/test_negation_skips.py compare the negated
automata of both packages: the skip traces' lengths and elements, the
exhaustive and seeded-random agreement with Python `re`'s complement,
and, at the reference's 200 KB, the number of folds of the positive and
the negated DNA motif proof (counted as `solve_and_batch`'s batches; the
reference's proving-time bound is not compared).
"""

import random
import re as pyre

import pytest

from _torch_support import (fresh_reference_terms,  # noqa: F401
                            no_compile_cache_writes, one_torch_thread)
from reef_tpu.backend import step_circuit as ref_step
from reef_tpu.backend import table as ref_table
from reef_tpu.backend import witness as ref_witness
from reef_tpu.frontend import parser as ref_parser
from reef_tpu.frontend import regex as ref_regex
from reef_tpu.frontend.safa import SAFA as RefSAFA
from reef_tpu_torch.backend import step_circuit, table, witness
from reef_tpu_torch.frontend.safa import from_regex
from reef_tpu_torch.ops import field as F

SALT, DOC_HASH = 0x5A17, 0xD0C4A54


def ref_safa(ab, rstr) -> RefSAFA:
    """The reference's automaton of `rstr` from a fresh process's terms."""
    fresh_reference_terms()
    return RefSAFA(ab, ref_regex.simpl(ref_parser.parse(rstr)))


class Side:
    """One package's table, step circuit and batches of a document."""

    def __init__(self, safa, tbl, step, wit, doc, batch_size):
        codes = [ord(c) for c in doc]
        udoc = tbl.doc_transform(safa.ab, codes)
        self.tt = tbl.TransitionTable(safa, udoc, len(udoc), len(codes),
                                      batch_size=batch_size)
        self.circ = step.StepCircuit(self.tt, DOC_HASH)
        self.batches = list(wit.solve_and_batch(self.tt, self.circ, codes,
                                                DOC_HASH, SALT))

    def check(self, wits):
        vec = self.circ.compiled.witness(wits)
        return self.circ.compiled.check_all(vec), len(vec)


def both(rstr, ab, doc, batch_size=2):
    port = Side(from_regex(ab, rstr), table, step_circuit, witness, doc,
                batch_size)
    ref = Side(ref_safa(ab, rstr), ref_table, ref_step, ref_witness, doc,
               batch_size)
    assert port.circ.compiled.num_constraints == \
        ref.circ.compiled.num_constraints
    assert [w for w, _ in port.batches] == [w for w, _ in ref.batches]
    for wits, _ in port.batches:
        got = port.check(dict(wits))
        assert got == ref.check(dict(wits)) and got[0] is None
    return port, ref


# ---------------------------------------------------------------------------
# the seven tampers (each edits the batch's witness dict in place)
# ---------------------------------------------------------------------------

def cursor0_continuity(tt, batches):
    # shift the whole cursor chain by +1 while cursor_in stays 0
    wits, _ = batches[0]
    for j in range(tt.batch_size):
        wits[f"cursor_{j+1}"] += 1
    return wits


def qbit_booleanity(tt, batches):
    wits, _ = batches[0]
    wits["nl_eq_0_q_0"] = 2            # not a bit
    return wits


def pop_on_empty_stack(tt, batches):
    wits, _ = batches[0]
    wits["rel_0"] = 3                  # a pop with an empty stack
    return wits


def push_hash_binding(tt, batches):
    for wits, _ in batches:
        if wits["rel_0"] >= 4:         # a push step
            wits["forall_0_kid_0"] = (wits["forall_0_kid_0"] + 1) % F.FQ.p
            return wits
    raise AssertionError("no push step found in trace")


def char_range_pinned(tt, batches):
    # (char_lo - t, char_hi + t*C) keeps lo*C + hi and widens the window
    wits, _ = batches[0]
    assert wits["char_lo_0"] == 1 and wits["char_hi_0"] == 1
    wits["char_lo_0"] = 0
    wits["char_hi_0"] = 1 + tt.num_chars
    return wits


def char_range_no_wrap(tt, batches):
    # char_lo = -1 mod p keeps lo*C + hi; assert_fits must reject it
    wits, _ = batches[0]
    assert wits["char_lo_0"] == 0 and wits["char_hi_0"] == 0
    wits["char_lo_0"] = (0 - 1) % F.FQ.p
    wits["char_hi_0"] = 0 + tt.num_chars
    return wits


def offset_window(tt, batches):
    # claim another offset of the {3} skip with consistent cursors
    wits, _ = batches[0]
    assert wits["offset_0"] == 3
    wits["offset_0"] = 2
    wits["cursor_1"] = wits["cursor_in"] + 2
    return wits


TAMPERS = {
    "cursor0_continuity": ("^baa$", "ab", "baa", cursor0_continuity),
    "qbit_booleanity": ("^baa$", "ab", "baa", qbit_booleanity),
    "pop_on_empty_stack": ("^baa$", "ab", "baa", pop_on_empty_stack),
    "push_hash_binding": ("^(?=a.*).*b$", "ab", "aab", push_hash_binding),
    "char_range_pinned": ("^z$", "Az", "z", char_range_pinned),
    "char_range_no_wrap": ("^A$", "Az", "A", char_range_no_wrap),
    "offset_window": ("^.{3}b$", "ab", "aaab", offset_window),
}


@pytest.mark.parametrize("name", list(TAMPERS))
def test_tamper_breaks_the_same_constraint(name):
    rstr, ab, doc, tamper = TAMPERS[name]
    port, ref = both(rstr, ab, doc)
    got = port.check(tamper(port.tt, port.batches))
    want = ref.check(tamper(ref.tt, ref.batches))
    assert got[0] is not None, f"{name}: the port's circuit accepts it"
    assert want[0] is not None
    assert got == want


# ---------------------------------------------------------------------------
# the negated automaton's skips
# ---------------------------------------------------------------------------

def _codes(doc: str):
    return [ord(c) for c in doc]


def neg_pair(ab, rs):
    return (from_regex(ab, rs).negate(), ref_safa(ab, rs).negate())


def trace_key(tr):
    """A trace as package-free tuples, or None."""
    if tr is None:
        return None
    return [(e.from_node, e.edge[0],
             e.edge[1] if e.edge[0] == "c" else e.edge[1].ranges,
             e.to_node, e.from_cur, e.to_cur) for e in tr]


def solve_both(pair, doc, native=False):
    port, ref = pair
    got = trace_key(port.solve(_codes(doc), native=native))
    assert got == trace_key(ref.solve(_codes(doc), native=native)), doc
    return got


def test_dual_empty_state_jumps_to_eof():
    tr = solve_both(neg_pair("abx", "^abc"), "x" + "a" * 5000)
    assert tr is not None and len(tr) < 12, tr and len(tr)


def test_dual_single_offset_skip_trace_constant():
    k = 4000
    tr = solve_both(neg_pair("ACGT", f"^.{{{k}}}TTTT.*"), "A" * (k + 50))
    assert tr is not None and len(tr) < 20


def test_dual_bounded_range_skip_trace_short():
    tr = solve_both(neg_pair("ACGT", "^.{3000,3003}TTTT.*"), "A" * 3600)
    assert tr is not None and len(tr) < 60


@pytest.mark.parametrize("rs", [
    ".{2,5}ab", "^.{1,3}b$", "a.{0,2}b", "^(?:a|.{2,4}b)$",
    ".{3,6}(?:a|bb)", "^.{2,3}$",
])
def test_dual_range_fork_oracle_exhaustive(rs):
    """Both negated automata agree with each other, trace for trace, and
    with the python-re complement on every doc up to length 8."""
    pair = neg_pair("ab", rs)
    crx = pyre.compile(rs)
    for n in range(0, 9):
        for i in range(2 ** n):
            doc = "".join("ab"[(i >> j) & 1] for j in range(n))
            got = solve_both(pair, doc) is not None
            assert got == (crx.search(doc) is None), (rs, doc)


def test_double_negation_roundtrip():
    rng = random.Random(3)
    for rs in (".{2,4}ab", "^a*b$", "a|b.{1,3}a"):
        port_nn = from_regex("ab", rs).negate().negate()
        ref_nn = ref_safa("ab", rs).negate().negate()
        port, ref = from_regex("ab", rs), ref_safa("ab", rs)
        for _ in range(40):
            doc = "".join(rng.choice("ab")
                          for _ in range(rng.randrange(0, 10)))
            a = solve_both((port, ref), doc) is not None
            b = solve_both((port_nn, ref_nn), doc) is not None
            assert a == b, (rs, doc)


def test_negation_fuzz_vs_python_re():
    """The reference's seeded random regexes (concats, alternations,
    stars, counted repeats, range skips), negated in both packages and
    checked against each other and the python-re complement."""
    rng = random.Random(12345)

    def rand_regex(depth=3):
        if depth == 0:
            return rng.choice(["a", "b", "."])
        c = rng.randrange(7)
        d = depth - 1
        if c == 0:
            return rand_regex(d) + rand_regex(d)
        if c == 1:
            return f"(?:{rand_regex(d)})|(?:{rand_regex(d)})"
        if c == 2:
            return f"(?:{rand_regex(d)})*"
        if c == 3:
            return (f"(?:{rand_regex(d)})"
                    f"{{{rng.randrange(1, 4)},{rng.randrange(4, 7)}}}")
        if c == 4:
            return (f".{{{rng.randrange(1, 5)},{rng.randrange(5, 9)}}}"
                    + rand_regex(d))
        if c == 5:
            return f".{{{rng.randrange(1, 6)}}}" + rand_regex(d)
        return rand_regex(d)

    total = 0
    for _ in range(40):
        rs = rand_regex()
        pair, errs = [], []
        for build in (lambda: from_regex("ab", rs).negate(),
                      lambda: ref_safa("ab", rs).negate()):
            try:
                pair.append(build())
            except Exception as e:
                errs.append(type(e).__name__)
        assert len(errs) in (0, 2) and len(set(errs)) < 2, (rs, errs)
        try:
            crx = pyre.compile(rs)
        except pyre.error:
            continue
        if errs:
            continue
        for _ in range(6):
            doc = "".join(rng.choice("ab")
                          for _ in range(rng.randrange(0, 11)))
            got = solve_both(pair, doc) is not None
            assert got == (crx.search(doc) is None), (rs, doc)
            total += 1
    assert total >= 150, total


def _folds(safa, tbl, step, wit, doc):
    codes = _codes(doc)
    udoc = tbl.doc_transform(safa.ab, codes)
    tt = tbl.TransitionTable(safa, udoc, len(udoc), len(codes), batch_size=0)
    circ = step.StepCircuit(tt, DOC_HASH)
    return sum(1 for _ in wit.solve_and_batch(tt, circ, codes, DOC_HASH,
                                              SALT))


def test_negated_dna_200kb_folds_as_reference():
    """The `-n` scaling check's fold counts: proving the non-match of the
    DNA motif regex takes at most one fold more than proving the match,
    and the port's counts equal the reference's."""
    n = 200_000
    motif = "ATGGGCTACAGAAACCGTGCCAAA"
    rng = random.Random(42)
    body = "".join(rng.choice("ACGT") for _ in range(n - len(motif)))
    regex = f"^.{{{n - len(motif)}}}{motif}.*"
    folds = {}
    for neg, doc in ((False, body + motif), (True, body + "A" * len(motif))):
        port, ref = from_regex("ACGT", regex), ref_safa("ACGT", regex)
        if neg:
            port, ref = port.negate(), ref.negate()
        solve_both((port, ref), doc, native=None)
        folds[neg] = (_folds(port, table, step_circuit, witness, doc),
                      _folds(ref, ref_table, ref_step, ref_witness, doc))
        assert folds[neg][0] == folds[neg][1], folds
    assert folds[True][0] <= folds[False][0] + 1, folds
