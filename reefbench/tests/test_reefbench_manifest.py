"""BENCHMARK.json's keys, names, units and limits, and the files it
names found by name.  Run on the CPU: `python -m pytest reefbench/tests -q`."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import loop, manifest  # noqa: E402

MAN = manifest.load_manifest()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def _line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_and_paths():
    assert set(MAN) == TOP
    assert MAN["command"] == ["python3", "reefbench/run.py"]
    assert MAN["paths"] == ["reefbench"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    # room for 24 cells: 2 + 14 runs a cell of run_seconds + 60 s, 180 s a
    # cell to build, 1,200 s spare, in 12 hours
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert os.path.getsize(os.path.join(manifest.REPO, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert manifest.valid_name(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(manifest.valid_name(k) for k in c["reduced"])
        assert c["file"] == f"reefbench/configs/{c['name']}.json"
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert manifest.valid_name(w["name"]) and _line(w["why"])
        assert manifest.valid_name(w["traffic"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for sec, extra in (("end_to_end", {"bound"}),
                       ("per_layer", {"layer", "moves"})):
        for m in MAN[sec]:
            keys = {"name", "unit", "better", "source"} | extra
            assert set(m) - {"workloads"} == keys, m["name"]
            assert manifest.valid_name(m["name"])
            assert manifest.valid_unit(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in (E2E_SOURCES if sec == "end_to_end"
                                   else SOURCES)
            names.append(m["name"])
    assert len(names) == len(set(names))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25


def test_each_cell_finds_its_files_and_reports_enough():
    cells = {w["name"] for w in MAN["workloads"]}
    used = set()
    pairs = set()
    for w in MAN["workloads"]:
        cfg = manifest.config(w["config"])
        mix = manifest.traffic(w["traffic"])
        assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
        used.add(w["config"])
        pairs.add((w["config"], w["traffic"]))
        e2e = {m["name"] for m in manifest.metrics_of(MAN, "end_to_end",
                                                      w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.metrics_of(MAN, "per_layer", w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    assert used == {c["name"] for c in MAN["configs"]}
    assert len(pairs) == len(MAN["workloads"])
    for sec in ("end_to_end", "per_layer"):
        for m in MAN[sec]:
            assert set(m.get("workloads", cells)) <= cells


def test_every_metric_has_a_reader_that_reads_nothing_from_nothing():
    for m in MAN["per_layer"]:
        reader = manifest.metric_reader(m["name"])
        assert callable(reader.read)
        assert _line(m["layer"])
    empty = loop.Run([], {"busy_s": 1.0, "window_s": 2.0,
                          "roofline_pct": None})
    for name in ("frontend.safa_s", "routes.sumcheck_s",
                 "kernel.roofline_pct"):
        assert manifest.metric_reader(name).read(empty) is None


def test_configs_state_source_reductions_and_guarantees():
    for c in MAN["configs"]:
        cfg = manifest.config(c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["guarantees"] and cfg["alphabet"] in ("dna", "ascii")
        assert len(cfg["motif"]) < cfg["doc_bytes"]


def test_files_added_in_another_directory_are_found_by_name(tmp_path):
    root = str(tmp_path)
    for kind in ("configs", "traffic", "metrics", "counts"):
        os.makedirs(os.path.join(root, kind))
    cfg = manifest.config("dna_1mb")
    cfg.update(name="dna_10kb", doc_bytes=10000)
    with open(os.path.join(root, "configs", "dna_10kb.json"), "w") as fh:
        json.dump(cfg, fh)
    shutil.copy(os.path.join(BENCH, "traffic", "fresh.json"),
                os.path.join(root, "traffic", "burst.json"))
    with open(os.path.join(root, "metrics", "prover.extra_s.py"), "w") as fh:
        fh.write("def read(run):\n    return 1.5\n")
    with open(os.path.join(root, "counts", "newkern.py"), "w") as fh:
        fh.write("KERNELS = ('new_kernel',)\n\n\ndef work(fn, args):\n"
                 "    return args[0], 0\n")
    assert manifest.config("dna_10kb", root)["doc_bytes"] == 10000
    assert manifest.traffic("burst", root)["roles"]
    assert manifest.metric_reader("prover.extra_s", root).read(None) == 1.5
    assert manifest.work_counts(root)["newkern"].work("x", (7,)) == (7, 0)
    with pytest.raises(ValueError):
        manifest.config("../configs/dna_1mb", root)
