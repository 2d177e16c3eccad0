"""The port's frontend held to the JAX package's over the reference's
regex corpora, on the CPU.

For every regex of three sources,

  * the reference's corpora: tests/test_frontend.py `CORPUS`, the regexes
    of tests/test_unicode.py and the ten of workloads/run.py;
  * tests/test_frontend.py's random-regex grammar (`_gen_regex`), seeded;
  * the negation fuzz's grammar of tests/test_frontend.py (with
    lookaheads), seeded, each automaton negated,

both packages build the automaton from a fresh process's terms (the
port's `frontend/safa.py` `from_regex`; `fresh_reference_terms` and
`SAFA` on the reference side), and its canonical fingerprint must be
equal: the states with their quantifier and regex text, the edges with
their labels, the forks, the accepting states and the sink,
`projection()`, `max_skip_offset()`, `max_forall_fanout()`, and the same
of `negate()`.  The `solve` traces on seeded documents must be equal up
to epsilon steps (`equiv_upto_epsilon`).  For a subset that covers `-n`,
`-p`, `-y` and `-m`, the deterministic public setup
(`backend/framework.py` `pub_setup`) must give the same table key, the
same R1CS shape sizes and the same digest of its A, B and C matrices.
"""

import importlib.util
import os
import random
import re as pyre

import pytest
import torch

from _torch_support import (fresh_reference_terms,  # noqa: F401
                            no_compile_cache_writes, one_torch_thread)
from reef_tpu.backend import framework as ref_fw
from reef_tpu.frontend import parser as ref_parser
from reef_tpu.frontend import regex as ref_regex
from reef_tpu.frontend.safa import SAFA as RefSAFA
from reef_tpu.utils import serialize as ref_sz
from reef_tpu_torch.backend import framework as FW
from reef_tpu_torch.frontend.openset import OpenSet
from reef_tpu_torch.frontend.safa import equiv_upto_epsilon, from_regex
from reef_tpu_torch.frontend.trace import TraceElem
from reef_tpu_torch.utils import device
from reef_tpu_torch.utils import serialize as sz
from test_frontend import CORPUS, _gen_regex
from test_unicode import CLASS_REGEXES, SOLVE_CASES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASCII = "".join(chr(c) for c in range(128))
ALPHABETS = {"ascii": ASCII, "dna": "ACGT", "utf8": None}


def _reference_workloads():
    spec = importlib.util.spec_from_file_location(
        "_reference_workloads_run", os.path.join(ROOT, "workloads", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.WORKLOADS


def _workload_cases(size=256):
    """(regex, alphabet, documents, negate) of each workload at `size`."""
    out = {}
    for name, w in _reference_workloads().items():
        doc = w["doc"](size, random.Random(42))
        out[f"workload-{name}"] = (w["regex"](len(doc)),
                                   ALPHABETS[w["alphabet"]], [doc],
                                   "-n" in w["flags"])
    return out


def _random_cases():
    """tests/test_frontend.py's grammar, seeded, 150 regexes."""
    rng = random.Random(20261017)
    out = {}
    for _ in range(150):
        rs = "^" + _gen_regex(rng, 3) + "$"
        docs = ["".join(rng.choice("ab") for _ in range(rng.randrange(1, 8)))
                for _ in range(4)]
        out.setdefault(f"random-{rs}", (rs, "ab", docs, False))
    return out


def _negated_cases():
    """The negation fuzz's grammar (with lookaheads), seeded, 60 regexes,
    each automaton negated."""
    rng = random.Random(271828 + 1)

    def gen(depth, look=True):
        if depth == 0:
            return rng.choice(["a", "b", "[ab]", "."])
        r = rng.random()
        if r < 0.3:
            return gen(depth - 1, look) + gen(depth - 1, False)
        if r < 0.55:
            return ("(" + gen(depth - 1, False) + "|" + gen(depth - 1, False)
                    + ")")
        if r < 0.7:
            return "(" + gen(depth - 1, False) + ")*"
        if r < 0.8:
            return "(" + gen(depth - 1, False) + ")?"
        if r < 0.9 and look:
            return "(?=" + gen(depth - 1, False) + ")" + gen(depth - 1, False)
        return gen(depth - 1, look)

    out = {}
    for _ in range(60):
        rs = "^" + gen(rng.choice([2, 3])) + "$"
        docs = ["".join(rng.choice("ab") for _ in range(rng.randrange(1, 7)))
                for _ in range(4)]
        out.setdefault(f"negated-{rs}", (rs, "ab", docs, True))
    return out


def _corpus_cases():
    out = {}
    for rs, doc, ab in CORPUS:
        out.setdefault(f"corpus-{rs}~{ab}", (rs, ab, [], False))[2].append(doc)
    for rs in CLASS_REGEXES:
        out.setdefault(f"unicode-{rs}", (rs, None, [], False))
    for rs, doc, _ in SOLVE_CASES:
        out.setdefault(f"unicode-{rs}", (rs, None, [], False))[2].append(doc)
    out["unicode-negate-^ab$"] = ("^ab$", None, ["a世", "ab"], True)
    return out


CASES = {**_corpus_cases(), **_workload_cases(), **_random_cases(),
         **_negated_cases()}


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def _label(lbl):
    kind, val = lbl
    return (kind, val if kind == "c" else val.ranges)


def fingerprint(safa) -> dict:
    n = safa.num_states()
    return {
        "states": [(q.is_and, repr(q.get())) for q in safa.nodes],
        "edges": [[(dst, _label(lbl)) for dst, lbl in safa.out_edges[i]]
                  for i in range(n)],
        "forks": [safa.is_fork(i) for i in range(n)],
        "forall": safa.forall_nodes(),
        "exists": safa.exist_nodes(),
        "accepting": sorted(safa.accepting),
        "sink": safa.sink,
        "projection": safa.projection(),
        "max_skip_offset": safa.max_skip_offset(),
        "max_forall_fanout": safa.max_forall_fanout(),
    }


def build(ab, rs, negate):
    """The port's and the reference's automata (negated where asked), or
    the name of the exception each build raised."""
    out = []
    for make in (lambda: from_regex(ab, rs),
                 lambda: (fresh_reference_terms(),
                          RefSAFA(ab, ref_regex.simpl(
                              ref_parser.parse(rs))))[1]):
        try:
            safa = make()
            out.append(safa.negate() if negate else safa)
        except Exception as e:
            out.append(type(e).__name__)
    return out


def _python_re(rs):
    try:
        return pyre.compile(rs)
    except pyre.error:
        return None


def as_port_trace(trace):
    """A reference trace as the port's TraceElems."""
    return [TraceElem(e.from_node,
                      e.edge if e.edge[0] == "c"
                      else (e.edge[0], OpenSet(e.edge[1].ranges)),
                      e.to_node, e.from_cur, e.to_cur) for e in trace]


@pytest.mark.parametrize("case", list(CASES))
def test_automaton_and_traces_equal_reference(case):
    rs, ab, docs, negate = CASES[case]
    port, ref = build(ab, rs, negate)
    if isinstance(port, str) or isinstance(ref, str):
        assert port == ref, (rs, port, ref)
        return
    assert fingerprint(port) == fingerprint(ref), rs
    # the negation of each, built the same way
    neg = []
    for safa in (port, ref):
        try:
            neg.append(fingerprint(safa.negate()))
        except Exception as e:
            neg.append(type(e).__name__)
    assert neg[0] == neg[1], rs
    for doc in docs:
        codes = [ord(c) for c in doc]
        got, want = port.solve(codes), ref.solve(codes)
        assert (got is None) == (want is None), (rs, doc)
        if want is not None:
            assert equiv_upto_epsilon(got, as_port_trace(want)), (rs, doc)
        if ab == "ab" and _python_re(rs) is not None:
            assert (got is not None) == (
                (pyre.search(rs, doc) is None) if negate
                else (pyre.search(rs, doc) is not None)), (rs, doc)


# ---------------------------------------------------------------------------
# the deterministic public setup
# ---------------------------------------------------------------------------

# (regex, alphabet, document, batch size, -p, -y, -m, -n)
SETUP_CASES = {
    "plain": (".*b", "ab", "aaaaaaaab", 2, False, False, False, False),
    "negate": ("^ab$", ASCII, "aa", 0, False, False, False, True),
    "merkle": (".*b", ASCII, "aaaaaaaab", 0, False, False, True, False),
    "merkle-negate": ("^.{4}XYZ.*", ASCII, "hello world", 0, False, False,
                      True, True),
    "projections": ("^.{12}ab", "ab", "aaaaaaaaaaaaab", 0, True, False,
                    False, False),
    "hybrid": ("hello.*reef", ASCII, "hello big reef", 0, False, True,
               False, False),
    "proj-hybrid": ("^.{36}ACGT$", "ACGT", "A" * 36 + "ACGT", 0, True, True,
                    False, False),
    "password": ("^(?=.*[A-Z].*[A-Z])(?=.*[a-z]).{12}$", ASCII,
                 "ABcdefghijkl", 3, False, False, False, False),
    "utf8": ("café.*界", None, "naïve café 世界", 2, False, False, False,
             False),
}


def table_key(tt, commit, mc, merkle, hybrid):
    """The structural key pub_setup caches its circuit stack under."""
    return (tt.num_states, tt.num_chars, tt.max_offsets, len(tt.table),
            tuple(tt.table[:2]), tt.doc_len(), tt.hybrid_len,
            tt.batch_size, tt.max_stack, tt.max_branches, tt.kid_padding,
            tt.eps_code, tt.eof_code, tt.star_offset, tt.ep_num,
            tt.udoc_len, tt.doc_subset,
            tuple(tt.proj_chunk_idx) if tt.proj_chunk_idx else None,
            commit.doc_commit_hash(), commit.merkle_root,
            mc.height if mc else None, merkle, hybrid)


def setup_summary(fw, safa, commit, bs, proj, hybrid, merkle, udoc):
    tt, circuit, aug, shape, wc, ec, mc = fw.pub_setup(
        safa, commit, bs, proj, hybrid, merkle, udoc=udoc)
    return {"key": table_key(tt, commit, mc, merkle, hybrid),
            "table": list(tt.table),
            "arity": circuit.arity,
            "shape": (shape.n_cons, shape.n_wit, shape.n_io, shape.w_pad,
                      list(shape.io_names),
                      [len(rows) for rows, _, _ in shape._packed_mats]),
            "digest": shape.digest,
            "committers": (wc.n, ec.n)}


@pytest.mark.parametrize("case", list(SETUP_CASES))
def test_public_setup_equals_reference(case, monkeypatch):
    rs, ab, doc, bs, proj, hybrid, merkle, negate = SETUP_CASES[case]
    monkeypatch.setenv("REEF_DEVICE_MSM", "0")
    monkeypatch.setenv("REEF_DEVICE_SUMCHECK", "0")
    monkeypatch.setattr(device, "_SELECTED", torch.device("cpu"))
    port, ref = build(ab, rs, negate)
    codes = [ord(c) for c in doc]
    commit, _ = FW.run_committer(codes, port.ab, merkle, seed=3)
    ref_commit = ref_sz.loads(sz.dumps("cmt", commit), "cmt")
    # the prover's setup (with the document) and the verifier's (without)
    from reef_tpu_torch.backend.table import doc_transform
    udoc = doc_transform(port.ab, codes)
    for u in (udoc, None):
        got = setup_summary(FW, port, commit, bs, proj, hybrid, merkle, u)
        want = setup_summary(ref_fw, ref, ref_commit, bs, proj, hybrid,
                             merkle, u)
        assert got == want, case
