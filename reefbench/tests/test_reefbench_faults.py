"""The check that decides `correct`, driven through whole runs at a tiny
size on the CPU (`--device cpu`, the host routes; the look for a card is
skipped): sound runs pass; the control (control.py) and each fault the
cells can have, planted in the port underneath the timed path, fail.

The faults: an answer altered where it is produced (a commitment's row,
a proof's claim about the document, a verdict) and a fold step that
returns its state unchanged.
The cells have no batch whose mean could lose half of it, and no cell on
several cards, so no exchange between cards to leave out."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, REPO]

import control  # noqa: E402
from harness import guard, loop, manifest  # noqa: E402

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark's manifest, mixes and configurations with
    documents of 1,024 bytes."""
    root = str(tmp_path_factory.mktemp("tiny"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(BENCH, "traffic"),
                    os.path.join(root, "traffic"))
    os.makedirs(os.path.join(root, "configs"))
    for c in manifest.load_manifest()["configs"]:
        cfg = manifest.config(c["name"])
        cfg["doc_bytes"] = 1024
        with open(os.path.join(root, "configs", f"{c['name']}.json"),
                  "w") as fh:
            json.dump(cfg, fh)
    return root


def run(tiny, cell, **kw):
    res = loop.run_cell(cell, SEED, 2.0, False, device="cpu", repo=tiny,
                        bench=tiny, **kw)
    assert res["done"]
    return loop.judge(res)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    checks, correct = run(tiny, cell)
    assert correct, checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell):
    fill = manifest.config(cell.split(".")[0])["fill"]
    checks, correct = run(tiny, cell,
                          doc_filter=control.mutate(fill, SEED))
    assert not correct
    assert checks["commitments_off"][0] >= 1 or \
        checks["failed_requests"][0] >= 1


def _altered_commitment(orig):
    def committer(*a, **k):
        public, secret = orig(*a, **k)
        rows = public.nldoc.commit.row_commits
        rows[0], rows[1] = rows[1], rows[0]
        return public, secret
    return committer


def _altered_proof(orig):
    def prover(*a, **k):
        proofs = orig(*a, **k)
        proofs.consist.hash_d += 1
        return proofs
    return prover


def _altered_verdict(orig):
    return lambda *a, **k: not orig(*a, **k)


FAULTS = {
    "commitment": ("run_committer", _altered_commitment, "commitments_off"),
    "proof": ("run_prover", _altered_proof, "proofs_off"),
    "verdict": ("run_verifier", _altered_verdict, "verdicts_off"),
}


def refused_in_setup_or_incorrect(tiny, number=None):
    """A fault fails the set-up's warm-up cycle (the run raises and
    prints no result) or the check after the window."""
    try:
        checks, correct = run(tiny, "dna_1mb.fresh")
    except RuntimeError as e:
        assert "set-up" in str(e)
        return
    assert not correct
    if number:
        assert checks[number][0] >= 1, checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch, fault):
    from reef_tpu_torch.backend import framework
    name, make, number = FAULTS[fault]
    monkeypatch.setattr(framework, name, make(getattr(framework, name)))
    refused_in_setup_or_incorrect(tiny, number)


def test_a_fold_that_returns_its_state_unchanged(tiny, monkeypatch):
    from reef_tpu_torch.backend import ivc
    orig = ivc.FoldAccumulator.fold

    def fold(self, *a, **k):
        U, Wit, vecs = self.U, self.Wit, (self._az, self._bz, self._cz)
        out = orig(self, *a, **k)
        self.U, self.Wit = U, Wit
        self._az, self._bz, self._cz = vecs
        return out
    monkeypatch.setattr(ivc.FoldAccumulator, "fold", fold)
    refused_in_setup_or_incorrect(tiny)


def test_the_guard_finds_forbidden_modules(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "reef_tpu.cli", object())
    assert guard.loaded_forbidden() == ["jax", "reef_tpu"]
    (tmp_path / "x.py").write_text("import numpy\nfrom reef_tpu_torch "
                                   "import cli\nimport jax.numpy\n")
    assert guard.reference_imports(str(tmp_path)) == [
        "x.py: reef_tpu_torch", "x.py: jax.numpy"]


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    if subprocess.run([sys.executable, "-c", "import torch, sys; "
                       "sys.exit(torch.cuda.is_available())"]).returncode:
        pytest.skip("a CUDA card is present")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "reefbench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    r = subprocess.run([sys.executable, "reefbench/run.py", "--workload",
                        "dna_1mb.fresh", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
