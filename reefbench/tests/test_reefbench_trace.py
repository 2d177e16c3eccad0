"""The traced run's reduction, on a made-up window: busy time as the union
of device intervals, idle time split by the span the host was in, and the
roofline share from the launches' work over the kernels' device time."""

from __future__ import annotations

import os
import sys
import types

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import peaks, trace  # noqa: E402


class FakeTracer(trace.Tracer):
    def __init__(self, events, spans, launches, window):
        self.events, self.spans, self.launches = events, spans, launches
        self.t0, self.t1 = 100.0, 100.0 + window

    def device_events(self):
        return self.events


def test_busy_idle_and_roofline():
    events = [(0, "void tree_level<0, true>(int)", 1.0, 1.5),
              (0, "void tree_level<0, true>(int)", 1.2, 2.0),   # overlaps
              (0, "Memcpy HtoD (Pageable -> Device)", 5.0, 5.5),
              (0, "void tree_level<1, false>(int)", 5.50005, 5.6)]
    spans = [("prove", 100.0, 106.0, 0), ("prove/prover", 101.0, 104.0, 1),
             ("prove/route.msm", 100.5, 102.0, 2), ("verify", 107.0, 109.0, 0)]
    counts = {"msm_tree": types.SimpleNamespace(
        KERNELS=("tree_level",),
        work=lambda fn, a: (a[0], 0))}
    rate = peaks.imads_per_s(132, 1980.0)
    launches = [("msm_tree", "reef_tree_levels", (int(0.5 * rate),)),
                ("padd", "reef_padd", (1,))]          # no count: left out
    s = trace.summarize(FakeTracer(events, spans, launches, 10.0), [0],
                        counts, 132, 1980.0)
    busy = 1.0 + 0.5 + 0.09995
    assert s["busy_s"] == pytest.approx(busy)
    idle = dict(s["breakdown"]["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(10.0 - busy)
    assert idle["prove/route.msm"] == pytest.approx(0.5)       # 0.5 - 1.0
    assert idle["prove/prover"] == pytest.approx(2.0)          # 2-4
    assert idle["prove"] == pytest.approx(0.5 + 1.0 + 0.4)
    assert idle["verify"] == pytest.approx(2.0)
    assert idle["between requests"] == pytest.approx(1.0 + 1.0)
    assert idle["between launches (under 0.1 ms)"] == pytest.approx(5e-5)
    assert s["measured_s"] == pytest.approx(0.5 + 0.8 + 0.09995)
    assert s["roofline_pct"] == pytest.approx(100 * 0.5 / 1.39995, rel=1e-6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["void tree_level<0, true>(int)"] == pytest.approx(1.3)


def test_stages_keep_timers_and_counters(tmp_path):
    """A `--metrics` CSV with both kinds of row: timers in seconds under
    (component, name), counters' events under ("count", component, name),
    summed over repeated rows; other rows left out."""
    from harness import loop
    path = tmp_path / "stages.csv"
    path.write_text(
        "time,Solver,nl_table,38000,μs\n"
        "time,Solver,nl_table,2000,μs\n"
        "constraints,Compiler,r1cs,123,constraints\n"
        "count,Solver,nl_table_card,1,events\n"
        "count,Solver,nl_table_card,2,events\n"
        "count,Prover,fold_steps,1,events\n", encoding="utf-8")
    stages = trace.read_stages(str(path))
    assert stages == {("Solver", "nl_table"): pytest.approx(0.04),
                      ("count", "Solver", "nl_table_card"): 3,
                      ("count", "Prover", "fold_steps"): 1}
    run = loop.Run([{"role": "prove", "stages": stages},
                    {"role": "prove", "stages": {}},
                    {"role": "verify", "stages": stages}], {})
    assert run.count_mean("prove", "Solver", "nl_table_card") == 1.5
    assert run.count_mean("prove", "Solver", "nl_table_host") is None
    assert run.stage_mean("prove", "Solver", "nl_table") == \
        pytest.approx(0.02)
    assert run.stage_mean("prove", "Solver", "nl_table_card") is None
