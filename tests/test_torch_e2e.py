"""reef_tpu_torch end to end against the JAX package, on the CPU.

The two packages' files must work with each other: a seeded commitment
is byte-identical, and each side's verifier accepts the other side's
`.cmt`/`.proof` pair (proofs are randomised, so their bytes differ), also
when the port proves on a mesh of eight CPU shards.  The
port also must not import JAX, the JAX package or its workload runner
(`workloads/`), nor may the card lane's tests (`tests/test_torch_card_*.py`
and their helper), and `chip_smoke.py`
must refuse to run where torch sees no CUDA device.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from _torch_support import (cross_verify, no_compile_cache_writes,  # noqa: F401
                            one_torch_thread, run_cli)
from reef_tpu import cli as ref_cli
from reef_tpu_torch import cli
from reef_tpu_torch.ops import poseidon_device, sumcheck_device
from reef_tpu_torch.parallel import mesh
from reef_tpu_torch.utils import device

pytestmark = pytest.mark.e2e

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (alphabet, document, regex, mode flags)
MERKLE = ("ascii", "aaaaaaaab", ".*b", ["-m"])
NEGATE = ("ascii", "aa", "^ab$", ["-n"])
DNA = ("dna", "ACGTTGCAAC", ".*TTG.*", [])
PROJ_HYBRID = ("dna", "A" * 36 + "ACGT", "^.{36}ACGT$", ["-p", "-y"])
# a document table of at least 16 entries, which splits over 8 shards
DNA_MESH = ("dna", "ACGTTGCAAC" * 2, ".*TTG.*", [])


@pytest.fixture(autouse=True)
def _host_routes(monkeypatch, tmp_path):
    """Each test works in its own directory, with the device routes at
    their defaults and the port's engine device unselected."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(device, "_SELECTED", None)


def _argv(case) -> list:
    """The port's `--e2e` arguments for `case`, its document written to
    doc.txt."""
    ab, doc, rx, flags = case
    with open("doc.txt", "w") as fh:
        fh.write(doc)
    return [ab, "--e2e", "-d", "doc.txt", "-r", rx, *flags, "--device", "cpu"]


@pytest.mark.parametrize("flags", [[], ["-m"]], ids=["hyrax", "merkle"])
def test_seeded_commitment_is_byte_identical(tmp_path, flags):
    (tmp_path / "doc.txt").write_text("hello world, hello reef")
    files = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", ref_cli.main, [])):
        (tmp_path / name).mkdir()
        shutil.copy(tmp_path / "doc.txt", tmp_path / name / "doc.txt")
        os.chdir(tmp_path / name)
        run_cli(main, ["ascii", "--commit", "-d", "doc.txt", "--seed", "7",
                    *flags, *extra])
        files[name] = sorted(os.listdir("."))
    assert files["port"] == files["ref"]
    for fname in files["port"]:
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "ref" / fname).read_bytes(), fname


@pytest.mark.parametrize("case", [MERKLE, NEGATE], ids=["merkle", "negate"])
@pytest.mark.parametrize("prover", ["port", "ref"])
def test_cross_verify(monkeypatch, case, prover):
    """One side commits and proves on its host routes, the other side
    verifies."""
    cross_verify(monkeypatch, _argv(case), prover, device_sumcheck=False)


@pytest.mark.parametrize("case", [DNA, PROJ_HYBRID], ids=["dna", "proj-hybrid"])
@pytest.mark.parametrize("prover", ["port", "ref"])
def test_cross_verify_device_sumcheck(monkeypatch, case, prover):
    """The port proves with every nlookup batch on its device route, whose
    Fiat-Shamir sponge is one state permuted at a time
    (`poseidon_device.permute` at B = 1, K5's launch of a block per state
    on the card), and the JAX package verifies; the JAX package proves on
    its host routes, and the port verifies."""
    batches = []
    orig = poseidon_device.permute

    def counted(lf, state):
        batches.append(state.shape[2])
        return orig(lf, state)

    if prover == "port":
        monkeypatch.setattr(poseidon_device, "permute", counted)
    cross_verify(monkeypatch, _argv(case), prover)
    assert prover == "ref" or (batches and set(batches) == {1})


def test_cross_verify_mesh_sumcheck(monkeypatch):
    """The port proves with every nlookup batch on its device route over a
    process mesh of eight CPU shards (the document's table split over
    them, `sharded_rounds`; the smaller transition table on the lead), and
    the JAX package verifies."""
    monkeypatch.setattr(mesh, "_PROCESS_MESH", None)
    mesh.select(["cpu"] * 8)
    sharded = []
    orig = sumcheck_device.sharded_rounds

    def counted(lf, t_shards, *a):
        if len(t_shards) > 1:
            sharded.append(len(t_shards))
        return orig(lf, t_shards, *a)

    monkeypatch.setattr(sumcheck_device, "sharded_rounds", counted)
    cross_verify(monkeypatch, _argv(DNA_MESH), "port")
    assert sharded and set(sharded) == {8}


def test_serve_answers_requests(tmp_path):
    (tmp_path / "doc.txt").write_text(MERKLE[1])
    env = dict(os.environ, PYTHONPATH=ROOT)
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
    yield os.path.join(ROOT, "tools", "card_pairs.py")
    # the card lane: its tests and their helper run where no JAX is
    tests = os.path.join(ROOT, "tests")
    card = sorted(n for n in os.listdir(tests)
                  if n.startswith("test_torch_card_") and n.endswith(".py"))
    assert len(card) >= 5, card
    for name in ["_torch_card_support.py"] + card:
        yield os.path.join(tests, name)


def test_port_imports_neither_jax_nor_reef_tpu():
    bad = []
    sources = list(_port_sources())
    assert len(sources) > 40
    assert any(p.endswith("_torch_card_support.py") for p in sources)
    assert any(p.endswith("card_pairs.py") for p in sources)
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
                if top in ("jax", "jaxlib", "reef_tpu", "workloads"):
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
