"""reef_tpu_torch end to end against the JAX package, on the CPU.

The two packages' files must work with each other: a seeded commitment
is byte-identical, and each side's verifier accepts the other side's
`.cmt`/`.proof` pair (proofs are randomised, so their bytes differ).  The
port also must not import JAX or the JAX package, and `chip_smoke.py`
must refuse to run where torch sees no CUDA device.
"""

import ast
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu import cli as ref_cli
from reef_tpu_torch import cli
from reef_tpu_torch.utils import device

pytestmark = pytest.mark.e2e

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (alphabet, document, regex, mode flags)
MERKLE = ("ascii", "aaaaaaaab", ".*b", ["-m"])
NEGATE = ("ascii", "aa", "^ab$", ["-n"])


@pytest.fixture(autouse=True)
def _host_routes(monkeypatch, tmp_path):
    """Each test works in its own directory, with the device routes at
    their defaults and the port's engine device unselected."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REEF_DEVICE_MSM", raising=False)
    monkeypatch.setattr(device, "_SELECTED", None)


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _port(mode: str, case, *extra) -> str:
    ab, doc, rx, flags = case
    return _run(cli.main, [ab, mode, "-d", "doc.txt", "-r", rx, *flags,
                           "--device", "cpu", *extra])


def _ref(mode: str, case, *extra) -> str:
    ab, doc, rx, flags = case
    return _run(ref_cli.main, [ab, mode, "-d", "doc.txt", "-r", rx, *flags,
                               *extra])


@pytest.mark.parametrize("flags", [[], ["-m"]], ids=["hyrax", "merkle"])
def test_seeded_commitment_is_byte_identical(tmp_path, flags):
    (tmp_path / "doc.txt").write_text("hello world, hello reef")
    files = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", ref_cli.main, [])):
        (tmp_path / name).mkdir()
        shutil.copy(tmp_path / "doc.txt", tmp_path / name / "doc.txt")
        os.chdir(tmp_path / name)
        _run(main, ["ascii", "--commit", "-d", "doc.txt", "--seed", "7",
                    *flags, *extra])
        files[name] = sorted(os.listdir("."))
    assert files["port"] == files["ref"]
    for fname in files["port"]:
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "ref" / fname).read_bytes(), fname


@pytest.mark.parametrize("case", [MERKLE, NEGATE], ids=["merkle", "negate"])
@pytest.mark.parametrize("prover", ["port", "ref"])
def test_cross_verify(tmp_path, case, prover):
    """One side commits and proves, the other side verifies."""
    (tmp_path / "doc.txt").write_text(case[1])
    if prover == "port":
        _port("--commit", case)
        _port("--prove", case)
        out = _ref("--verify", case)
    else:
        _ref("--commit", case)
        _ref("--prove", case)
        out = _port("--verify", case)
    assert "Verification PASSED" in out


def test_serve_answers_requests(tmp_path):
    (tmp_path / "doc.txt").write_text(MERKLE[1])
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("REEF_DEVICE_MSM", None)
    p = subprocess.Popen([sys.executable, "-m", "reef_tpu_torch.cli", "serve"],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         text=True, env=env, cwd=tmp_path)
    try:
        def rpc(argv):
            p.stdin.write(json.dumps({"argv": argv}) + "\n")
            p.stdin.flush()
            return json.loads(p.stdout.readline())

        assert json.loads(p.stdout.readline()).get("ready")
        ab, _, rx, flags = MERKLE
        r = rpc([ab, "--e2e", "-d", "doc.txt", "-r", rx, *flags,
                 "--device", "cpu"])
        assert r["ok"] and "Verification PASSED" in r["output"]
        r = rpc([ab, "--verify", "-d", "doc.txt", "-r", "NOSUCH((", *flags,
                 "--device", "cpu"])
        assert not r["ok"] and r.get("error")
        r = rpc([ab, "--verify", "-d", "doc.txt", "-r", rx, *flags,
                 "--device", "cpu"])
        assert r["ok"]
    finally:
        p.stdin.close()
        p.wait(timeout=60)


def _port_sources():
    pkg = os.path.join(ROOT, "reef_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_reef_tpu():
    bad = []
    sources = list(_port_sources())
    assert len(sources) > 40
    for path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                if top in ("jax", "jaxlib", "reef_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:"
                               f"{node.lineno}: {mod}")
    assert not bad, bad


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device; chip_smoke.py would run")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd in (ROOT, str(alone)):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
