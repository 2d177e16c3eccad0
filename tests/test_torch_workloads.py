"""The port's workload suite (`reef_tpu_torch/workloads.py`) against the
JAX package's (`workloads/run.py`), on the CPU.

The port's table makes the same documents, regexes and flags as the
reference's; its serve mode runs, one worker across alphabets and
flags; the CLI's automaton for a workload's regex does not depend on the
regexes the process built before; and two workloads prove with one
package and verify with the other.  The
other workloads' cross-verify cases are in `test_torch_workloads_*.py`,
split so that each file stays short on one test worker.
"""

import importlib.util
import os
import random
import subprocess
import sys

import pytest

from _torch_support import (XV_SIZES, fresh_reference_terms,
                            no_compile_cache_writes,  # noqa: F401
                            one_torch_thread, workload_cross_verifies)
from reef_tpu import cli as ref_cli
from reef_tpu_torch import cli, workloads
from reef_tpu_torch.frontend import parser
from reef_tpu_torch.frontend import regex as R
from reef_tpu_torch.frontend.safa import SAFA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_run():
    """The JAX package's workloads/run.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "_reference_workloads_run", os.path.join(ROOT, "workloads", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_table_names_match_reference():
    assert list(workloads.WORKLOADS) == list(_reference_run().WORKLOADS)
    assert set(XV_SIZES) == set(workloads.WORKLOADS) - {"dna"}


@pytest.mark.parametrize("name", list(workloads.WORKLOADS))
def test_table_matches_reference(name):
    """(alphabet, regex, document bytes, flags) at three sizes."""
    ref = _reference_run().WORKLOADS[name]
    for size in (48, 1000, 102400):
        doc = ref["doc"](size, random.Random(42))
        want = (ref["alphabet"], ref["regex"](len(doc)), doc.encode("utf-8"),
                ref["flags"])
        assert workloads.case(name, size) == want, (name, size)


def test_documents_are_written_as_utf8(tmp_path):
    argv = workloads.argv_for("unicode_mn", 300, str(tmp_path), device="cpu")
    path = argv[argv.index("-d") + 1]
    with open(path, "rb") as fh:
        raw = fh.read()
    assert raw == workloads.case("unicode_mn", 300)[2]
    assert "🌍" in raw.decode("utf-8")
    assert argv[argv.index("--device") + 1] == "cpu"
    assert argv[argv.index("--cmt-name") + 1].startswith(str(tmp_path))


def test_serve_runs_a_workload(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "reef_tpu_torch.workloads", "password",
         "--serve", "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS" in r.stdout and "FAIL" not in r.stdout


def test_one_worker_serves_alphabets_and_modes(monkeypatch, tmp_path):
    """One serve worker proves utf8 with -m -n, then ascii with -p -y,
    then dna on Hyrax: its caches (automata, generators, bases) hold
    across requests of other alphabets and flags."""
    worker = workloads.ServeWorker()
    try:
        for name in ("unicode_mn", "proj_hybrid", "dna"):
            ok, _, _ = workloads.run_one(name, 64, worker=worker,
                                         device="cpu")
            assert ok, name
    finally:
        worker.close()
    assert worker.proc.returncode == 0


def test_runner_refuses_a_card_it_lacks(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "reef_tpu_torch.workloads", "password"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode != 0 and "FAIL" in r.stdout


@pytest.mark.parametrize("prover", ["port", "ref"])
@pytest.mark.parametrize("name", ["pihole", "proj_hybrid"])
def test_workload_cross_verifies(monkeypatch, tmp_path, name, prover):
    workload_cross_verifies(monkeypatch, tmp_path, name, prover)


def _automaton(safa) -> list:
    """A SAFA's nodes (term, quantifier, accepting) and edges, in order."""
    return [(repr(q.get()), q.is_and, i in safa.accepting,
             [(dst, kind, repr(lbl)) for dst, (kind, lbl)
              in safa.out_edges[i]])
            for i, q in enumerate(safa.nodes)] + [safa.sink]


# regexes a process may have built before: the JAX package's password-policy
# e2e test's, through SAFA directly, and two through the CLI
HISTORIES = {
    "fresh": [],
    "policy": [("AaBbZz", "^(?=.*[A-Z])(?=.*[a-z]).{6}$", False)],
    "cli": [(None, "^(.+[_.-])?telemetry[_.-]", False),
            (None, "^.{1000}FORBIDDEN-MARKER-XYZQ.*", True)],
}


@pytest.mark.parametrize("history", list(HISTORIES))
@pytest.mark.parametrize("name", ["password", "pihole", "unicode_mn"])
def test_automaton_does_not_depend_on_earlier_regexes(monkeypatch, history,
                                                      name):
    """The CLI's automaton for a workload's regex is the one a fresh
    process of the JAX package builds, whatever regexes the process built
    before (a serve worker's earlier requests)."""
    import argparse
    ab_name, regex, _, flags = workloads.case(name, 64)
    args = argparse.Namespace(alphabet=ab_name, re=regex,
                              negate="-n" in flags, alpha_numeric=False,
                              basic_english=False, ignore_whitespace=False,
                              case_insensitive=False)
    ab = cli.build_alphabet(args)
    monkeypatch.setattr(cli, "_SAFA_CACHE", {})
    R.reset_terms()                      # the port as a fresh process
    for alphabet, rx, negate in HISTORIES[history]:
        if alphabet is None:
            cli.build_safa(argparse.Namespace(re=rx, negate=negate),
                           list(range(128)))
        else:
            SAFA(alphabet, R.simpl(parser.parse(rx)))
    got = _automaton(cli.build_safa(args, ab))
    fresh_reference_terms()
    assert got == _automaton(ref_cli.build_safa(args, ab))
