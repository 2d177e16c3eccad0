"""The traffic generator: the same documents and queries from the same
seed, the same sizes from every seed."""

from __future__ import annotations

import os
import re
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import manifest  # noqa: E402
from harness.traffic import Traffic  # noqa: E402


# a configuration of text over the ascii alphabet, as a later cell may
# bring one, beside the manifest's
TEXT = {"name": "text", "alphabet": "ascii", "doc_bytes": 4096,
        "fill": "abcdefghijklmnopqrstuvwxyz", "motif": "needleinhaystack",
        "flags": [], "batch_size": 0}
CONFIGS = [c["name"] for c in manifest.load_manifest()["configs"]] + ["text"]


def small(config: str, n: int = 4096) -> dict:
    cfg = dict(TEXT) if config == "text" else manifest.config(config)
    cfg["doc_bytes"] = n
    return cfg


def stream(cfg: dict, mix: str, seed: int, k: int = 5):
    t = Traffic(cfg, manifest.traffic(mix), seed)
    cycles = t.warmup() + [t.cycle(i) for i in range(k)]
    return [(c.regex, c.commit_seed, t.document(c.doc_key))
            for c in cycles]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("mix", ["fresh", "same_doc"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, -5])
def test_same_seed_same_traffic(config, mix, seed):
    cfg = small(config)
    a, b = stream(cfg, mix, seed), stream(cfg, mix, seed)
    assert a == b
    other = stream(cfg, mix, seed + 1)
    assert [x[0] for x in a] != [x[0] for x in other] or \
        [x[2] for x in a] != [x[2] for x in other]
    assert [len(x[2]) for x in a] == [len(x[2]) for x in other]
    for regex, _, doc in a:
        assert len(doc) == cfg["doc_bytes"]
        assert set(doc[:-len(cfg["motif"])]) <= set(cfg["fill"].encode())
        assert re.search(regex, doc.decode(), re.DOTALL)


def test_fresh_documents_differ_and_end_in_the_motif():
    cfg = small("dna_1mb")
    docs = [x[2] for x in stream(cfg, "fresh", 3)]
    assert len(set(docs)) == len(docs)
    assert all(d.endswith(cfg["motif"].encode()) for d in docs)
    assert len({x[0] for x in stream(cfg, "fresh", 3)}) == 1


def test_same_doc_queries_one_document_never_the_same_offset():
    cfg = small("dna_1mb", 2000)
    t = Traffic(cfg, manifest.traffic("same_doc"), 9)
    setup, warm = t.setup_commit(), t.warmup()
    cycles = [t.cycle(i) for i in range(400)]
    assert len(warm) == 3
    assert {c.doc_key for c in warm + cycles} == {setup.doc_key}
    offs = [int(re.match(r"\^\.\{(\d+)\}", c.regex).group(1))
            for c in warm + cycles]
    assert len(set(offs)) == len(offs)
    doc = t.document(setup.doc_key).decode()
    for c, off in zip(warm + cycles, offs):
        assert c.regex == f"^.{{{off}}}{doc[off:off + 24]}.*"
