"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`); a per-layer metric has a reader
(`metrics/<name>.py`) and a kernel library a work count
(`counts/<name>.py`).  Adding any of them is adding a file and an entry.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def valid_name(s) -> bool:
    return isinstance(s, str) and NAME.fullmatch(s) is not None


def valid_unit(s) -> bool:
    return isinstance(s, str) and UNIT.fullmatch(s) is not None


def load_manifest(repo: str = REPO) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(root: str, kind: str, name: str) -> dict:
    if not valid_name(name):
        raise ValueError(f"{kind}: invalid name {name!r}")
    with open(os.path.join(root, kind, f"{name}.json")) as fh:
        return json.load(fh)


def config(name: str, root: str = BENCH) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root: str = BENCH) -> dict:
    return _json(root, "traffic", name)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def metrics_of(manifest: dict, section: str, cell_name: str) -> List[dict]:
    """The metrics of `section` that the cell reports."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def _module(path: str, tag: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = BENCH) -> ModuleType:
    if not valid_name(name):
        raise ValueError(f"metric: invalid name {name!r}")
    return _module(os.path.join(root, "metrics", f"{name}.py"),
                   f"reefbench_metric_{name.replace('.', '_')}")


def work_counts(root: str = BENCH) -> Dict[str, ModuleType]:
    """Every kernel library's work count, by library name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "counts", "*.py"))):
        name = os.path.basename(path)[:-3]
        out[name] = _module(path, f"reefbench_count_{name}")
    return out
