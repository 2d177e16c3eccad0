"""The port's spans and counters (`reef_tpu_torch/utils/metrics.py`) on
the CPU: a request run with `--metrics FILE` records them where the work
happens, nested on the request thread, and writes a `time` row for each
span and a `count` row for each counter, which the benchmark's readers
(`reefbench/metrics/`) find; a request without it records nothing.
"""

import csv
import gc
import os
import sys
import threading

import pytest

from _torch_support import one_torch_thread  # noqa: F401
from reef_tpu_torch import cli
from reef_tpu_torch.backend import framework as FW
from reef_tpu_torch.ec import msm, msm_v3
from reef_tpu_torch.utils import device, metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "reefbench")
# the readers this port's spans feed, and the spans they read
READERS = {
    "prover.solve_s": [("Solver", "solve")],
    "prover.fold_step_s": [("Prover", "fold_step")],
    "prover.fold_wait_s": [("Solver", "wait_fold")],
    "prover.spartan_sumcheck_s": [("Prover", "spartan.sumcheck1"),
                                  ("Prover", "spartan.sumcheck2")],
    "prover.spartan_open_s": [("Prover", "spartan.open")],
    "prover.ipa_s": [("Prover", "ipa")],
    "routes.msm_host_s.prove": [("MSM", "scalars"), ("MSM", "upload"),
                                ("MSM", "combine")],
    "commit.rows_s": [("CommitmentGen", "rows")],
    "verifier.ivc_s": [("Verifier", "ivc_check")],
    "host.gc_s.prove": [("Host", "gc")],
}
# (child, parent): every child span on the request thread lies inside one
# of the parent's spans
NESTED = [
    (("Solver", "solve"), ("Solver", "fa_solver+wit")),
    (("Solver", "wait_fold"), ("Solver", "fa_solver+wit")),
    (("Prover", "spartan.open"), ("Prover", "compressed_snark")),
    (("Prover", "ipa"), ("Prover", "spartan.open")),
    (("Prover", "wait_spartan2"), ("Prover", "compressed_snark")),
    (("Compiler", "circuit"), ("Compiler", "r1cs_init")),
    (("CommitmentGen", "rows"), ("CommitmentGen", "generation")),
    (("CommitmentGen", "row_hash"), ("CommitmentGen", "generation")),
    (("Verifier", "consistency"), ("Verifier", "consistency_verification")),
    (("Verifier", "wait_ivc"), ("Verifier", "consistency_verification")),
]


@pytest.fixture
def e2e_argv(monkeypatch, tmp_path):
    """A tiny DNA `--e2e` on the host routes, in its own directory; the
    last request's spans and the engine device are restored after."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REEF_DEVICE_MSM", raising=False)
    monkeypatch.setattr(device, "_SELECTED", None)
    monkeypatch.setattr(metrics, "_LAST", metrics._LAST)
    (tmp_path / "doc.txt").write_text("ACGTTGCAAC")
    return ["dna", "--e2e", "-d", "doc.txt", "-r", ".*TTG.*", "--device",
            "cpu"]


@pytest.fixture
def frequent_gc():
    """Collections often enough that a tiny request has some."""
    prev = gc.get_threshold()
    gc.set_threshold(50)
    yield
    gc.set_threshold(*prev)


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _bench():
    """The benchmark's `Run`, its CSV reader and the readers above."""
    sys.path.insert(0, BENCH)
    try:
        from harness import loop, manifest, trace
    finally:
        sys.path.remove(BENCH)
    return (loop.Run, trace.read_stages,
            {name: manifest.metric_reader(name) for name in READERS})


def _inside(child, parents):
    return any(p[3] <= child[3] and child[4] <= p[4] for p in parents)


def test_metrics_csv_carries_the_spans_and_counters(e2e_argv, frequent_gc,
                                                     monkeypatch):
    seen = {}

    def spy(*a, **k):
        seen["current"] = metrics._CURRENT
        seen["hooked"] = any(getattr(cb, "__self__", None) is
                             metrics._CURRENT for cb in gc.callbacks)
        return run_prover(*a, **k)

    run_prover = FW.run_prover
    monkeypatch.setattr(FW, "run_prover", spy)
    callbacks = list(gc.callbacks)
    cli.main(e2e_argv + ["--metrics", "m.csv"])
    assert isinstance(seen["current"], metrics.Metrics) and seen["hooked"]
    assert metrics._CURRENT is None and gc.callbacks == callbacks

    rows = _rows("m.csv")
    times = {(r[1], r[2]): int(r[3]) for r in rows if r[0] == "time"}
    counts = {(r[1], r[2]): int(r[3]) for r in rows if r[0] == "count"}
    assert all(r[4] == "events" for r in rows if r[0] == "count")
    for spans in READERS.values():
        for key in spans:
            if key[0] != "MSM":         # no device MSM on the host routes
                assert times[key] > 0, key
    assert counts[("Host", "gc_collections")] > 0
    assert counts[("Prover", "fold_steps")] >= 1
    # every IPA on the host engine: the two Spartan proofs, the Hyrax
    # opening and the CAP's two
    assert counts[("IPA", "host")] == 5 and ("IPA", "device") not in counts
    for what in ("table", "circuit"):     # prove's and verify's pub_setup
        assert counts[("Compiler", f"{what}_cache_hit")] >= 1
        assert counts[("Compiler", f"{what}_cache_hit")] + \
            counts.get(("Compiler", f"{what}_cache_miss"), 0) == 2

    spans = metrics.last_spans()
    assert seen["current"].spans is spans
    main = threading.get_ident()
    mine = [s for s in spans if s[2] == main]
    # on the request thread, spans nest: a span that starts inside
    # another ends inside it
    stack = []
    for s in sorted(mine, key=lambda s: (s[3], -s[4])):
        while stack and stack[-1][4] <= s[3]:
            stack.pop()
        assert not stack or s[4] <= stack[-1][4], (s, stack[-1])
        stack.append(s)
    for child, parent in NESTED:
        kids = [s for s in mine if s[:2] == child]
        parents = [s for s in mine if s[:2] == parent]
        assert kids and all(_inside(k, parents) for k in kids), child
    # the folds run on the worker, the second Spartan proof beside the
    # first, the IVC check beside the consistency check
    threads = {key: {s[2] for s in spans if s[:2] == key}
               for key in (("Prover", "fold_step"),
                           ("Prover", "spartan.open"),
                           ("Verifier", "ivc_check"))}
    assert main not in threads[("Prover", "fold_step")]
    assert len(threads[("Prover", "spartan.open")]) >= 2
    assert main not in threads[("Verifier", "ivc_check")]

    # the MSM route's spans, from a device MSM of the kernels' plain
    # versions on CPU tensors
    ck = msm.pallas_kernels()
    pts = [ck.curve.mul(k + 2, ck.curve.gen) for k in range(4)] * 32
    basis = msm_v3.DeviceBasisV3(ck, pts, cap=128, device="cpu")
    scalars = list(range(1, 129))
    mt = metrics.Metrics()
    with metrics.recording(mt):
        got = msm_v3.msm_device_v3(ck, scalars, basis)
    assert got == ck.curve.msm(scalars, pts)
    for stage in ("scalars", "upload", "kernels", "combine"):
        assert mt.timers[("MSM", stage)] > 0, stage
    mt.write_csv("m.csv")

    Run, read_stages, readers = _bench()
    stages = read_stages("m.csv")
    run = Run([{"role": role, "stages": stages}
               for role in ("commit", "prove", "verify")], {})
    for name, reader in readers.items():
        assert reader.read(run) > 0, name


def test_without_metrics_nothing_records(e2e_argv, monkeypatch):
    seen = []
    run_prover = FW.run_prover

    def spy(*a, **k):
        seen.append(metrics._CURRENT)
        return run_prover(*a, **k)

    monkeypatch.setattr(FW, "run_prover", spy)
    last = metrics.last_spans()
    callbacks = list(gc.callbacks)
    cli.main(e2e_argv)
    assert seen == [None]
    assert gc.callbacks == callbacks
    assert metrics.last_spans() is last
    assert metrics.span("Prover", "fold_step") is \
        metrics.span("Solver", "solve")
