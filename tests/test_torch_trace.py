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
    "prover.nl_table_s": [("Solver", "nl_table")],
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
# the mesh's spans and counters (parallel/mesh.py), on a mesh only, and
# the readers of two of the spans
MESH_SPANS = [("Mesh", "scalars"), ("Mesh", "issue"), ("Mesh", "gather")]
MESH_READERS = {"mesh.issue_s.prove": ("Mesh", "issue"),
                "mesh.gather_s.prove": ("Mesh", "gather")}
# (child, parent): every child span on the request thread lies inside one
# of the parent's spans
NESTED = [
    (("Solver", "solve"), ("Solver", "fa_solver+wit")),
    (("Solver", "nl_table"), ("Solver", "solve")),
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
    """A tiny DNA `--e2e` on the host routes, in its own directory, from
    empty automaton, table and circuit caches (another test file in the
    same worker may have proved this document's shape: its prove and
    verify would then build no circuit); the caches, the last request's
    spans and the engine device are restored after."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "_SAFA_CACHE", {})
    monkeypatch.setattr(FW, "_TT_CACHE", {})
    monkeypatch.setattr(FW, "_CIRCUIT_CACHE", {})
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


def _bench(names=READERS):
    """The benchmark's `Run`, its CSV reader and the readers of `names`."""
    sys.path.insert(0, BENCH)
    try:
        from harness import loop, manifest, trace
    finally:
        sys.path.remove(BENCH)
    return (loop.Run, trace.read_stages,
            {name: manifest.metric_reader(name) for name in names})


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
    # one device: nothing of the mesh
    assert not [k for k in list(times) + list(counts) if k[0] == "Mesh"]
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


def test_a_new_document_restamps_the_circuit(e2e_argv):
    """A second `--e2e` on another document of the same length: its prove
    finds the first one's circuit stack and restamps its commitment hash
    (count and span, inside `r1cs_init`), its verify hits without one."""
    cli.main(e2e_argv)
    with open("doc.txt", "w") as fh:
        fh.write("CATTGGACCA")
    cli.main(e2e_argv + ["--metrics", "m.csv"])
    rows = _rows("m.csv")
    times = {(r[1], r[2]): int(r[3]) for r in rows if r[0] == "time"}
    counts = {(r[1], r[2]): int(r[3]) for r in rows if r[0] == "count"}
    assert counts[("Compiler", "circuit_restamp")] == 1
    assert counts[("Compiler", "circuit_cache_hit")] == 2
    assert ("Compiler", "circuit_cache_miss") not in counts
    assert times[("Compiler", "restamp")] > 0
    assert ("Compiler", "circuit") not in times
    spans = metrics.last_spans()
    kids = [s for s in spans if s[:2] == ("Compiler", "restamp")]
    parents = [s for s in spans if s[:2] == ("Compiler", "r1cs_init")]
    assert len(kids) == 1 and _inside(kids[0], parents)


@pytest.mark.parametrize("k", [4, 1])
def test_mesh_spans_and_counters_only_on_a_mesh(k, monkeypatch, tmp_path):
    """A commit MSM on the device route and an IPA on the round engine
    the routes take (the device routes taken on the CPU, where the
    kernels' plain versions run on CPU tensors): on a mesh of four CPUs
    the sharded MSM and `IpaMesh` record the mesh's spans and counters,
    which the `--metrics` CSV carries to the benchmark's readers; on one
    device (`msm_device_v3`, `IpaDevice`) none of them."""
    from reef_tpu_torch.backend import commitment as CM
    from reef_tpu_torch.backend import ipa, routes
    from reef_tpu_torch.ec.pasta import PALLAS
    from reef_tpu_torch.parallel import mesh as PM
    monkeypatch.setattr(device, "_SELECTED", None)
    device.select("cpu")
    values = list(range(1, 9))
    monkeypatch.setattr(PM, "_PROCESS_MESH",
                        PM.make_mesh(devices=["cpu"] * k))
    monkeypatch.setattr(routes, "_BASES", {})
    gens = CM.PedersenGens(PALLAS, b"test_torch_trace", len(values))
    mt = metrics.Metrics()
    with metrics.recording(mt), \
            routes.use(routes.Policy(cpu=True, msm=len(values), ipa=2)):
        assert gens.commit(values, 0) == PALLAS.msm(values, gens.G)
        eng = ipa._round_engine(gens, values[:4], values[4:])
        for x in (5, 7):
            eng.cross()
            eng.fold(x)
        eng.final()
        eng.close()
    took = {name for comp, name in mt.events if comp == "IPA"}
    mesh = [key for key in list(mt.timers) + list(mt.events)
            if key[0] == "Mesh"]
    assert mt.events[("MSM", "basis_upload")] == 1
    if k == 1:
        assert took == {"device"} and not mesh
        return
    assert took == {"mesh"}
    for key in MESH_SPANS:
        assert mt.timers[key] > 0, key
    # the MSM's four shards of two points; the IPA's vector of four fills
    # two of them, each round; the window sums gathered, (3, 8, 32) int32
    # an MSM's shard and (3, 8, 64) an IPA's
    assert mt.events[("Mesh", "shards")] == 4 + 2 * 2
    assert mt.events[("Mesh", "gather_bytes")] == \
        4 * 3 * 8 * 32 * 4 + 2 * 2 * 3 * 8 * 64 * 4
    mt.write_csv(str(tmp_path / "m.csv"))
    Run, read_stages, readers = _bench(MESH_READERS)
    run = Run([{"role": "prove",
                "stages": read_stages(str(tmp_path / "m.csv"))}], {})
    for name, key in MESH_READERS.items():
        assert readers[name].read(run) == \
            int(mt.timers[key] * 1e6) / 1e6 > 0, name


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
