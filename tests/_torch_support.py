"""Shared fixtures and helpers of the tests that hold reef_tpu_torch
against reef_tpu.

Import the two autouse fixtures into a test module to make them apply to
each of its tests.
"""

import contextlib
import dataclasses
import hashlib
import io
import os
import types

import jax
import pytest
import torch

from reef_tpu_torch.backend import routes

# every nlookup batch on its device route, whatever its table's size, the
# kernels' plain versions on a CPU engine; every other operation on the
# host
DEVICE_SUMCHECK_ONLY = dataclasses.replace(routes.ALL_HOST, cpu=True,
                                           sumcheck=1)


@pytest.fixture(autouse=True)
def no_compile_cache_writes():
    """Keep the reference's compiles in these tests out of the committed
    persistent compile cache (tests/.jax_cache): a compile may still read
    an entry, but writes none, however long it takes."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch's CPU ops on one thread: the suite runs several worker
    processes at once, and torch's thread pool in each of them, competing
    for the same cores, slowed these tests twenty-fold."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def device_selection_restored(monkeypatch):
    """For tests that run the port's CLI, whose `--device` selects the
    process's engine device: the selection before the test is restored
    after it."""
    from reef_tpu_torch.utils import device
    monkeypatch.setattr(device, "_SELECTED", device._SELECTED)


@pytest.fixture
def stand_in_card(monkeypatch):
    """For launch tests on CPU tensors with a stand-in library: a
    stand-in `torch.cuda.device` that records the device it makes
    current (`card.current`, None outside it) and a `current_stream`
    that hands out stream 0."""
    card = types.SimpleNamespace(current=None)

    @contextlib.contextmanager
    def make_current(dev):
        prev, card.current = card.current, torch.device(dev)
        try:
            yield
        finally:
            card.current = prev

    monkeypatch.setattr(torch.cuda, "device", make_current)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return card


def run_cli(main, argv) -> str:
    """One in-process CLI run; returns what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def verdict(verify, verify_error) -> str:
    """"accept" or "reject"; an exception other than the package's
    VerifyError propagates (a crash fails the test)."""
    try:
        return "accept" if verify() else "reject"
    except verify_error:
        return "reject"


def cli_verdict(main, argv, capsys) -> str:
    """"passed", "failed" (the verifier said no) or "error" (the CLI
    refused the input with an error line) of one `--verify`; a crash
    fails the test."""
    capsys.readouterr()
    try:
        out = run_cli(main, argv)
    except SystemExit as e:
        assert e.code == 1, e.code
        return "error" if "error:" in capsys.readouterr().err else "failed"
    assert "Verification PASSED" in out, out
    return "passed"


def resealed(data: bytes) -> bytes:
    """An artifact's bytes with their sha256-16 trailer made good
    again."""
    body = data[:-16]
    return body + hashlib.sha256(body).digest()[:16]


def repo_module(relpath: str):
    """A script of the repository (`chip_smoke.py`,
    `tools/card_pairs.py`), loaded by its path."""
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = "_" + os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pair_id(pair) -> str:
    return f"{pair['made_by']}-{pair['name']}"


def _in_mode(argv, mode: str) -> list:
    return [mode if a == "--e2e" else a for a in argv]


def _saves_then_stops(monkeypatch, serialize, after: int) -> None:
    """Make the prover stop (RuntimeError) right after its `after`-th
    checkpoint is written."""
    orig, saved = serialize.save, []

    def save(path, kind, obj):
        n = orig(path, kind, obj)
        if kind == "ckpt":
            saved.append(path)
            if len(saved) == after:
                raise RuntimeError("stopped after a checkpoint")
        return n

    monkeypatch.setattr(serialize, "save", save)


def fresh_reference_terms() -> None:
    """Give the JAX package the regex terms of a fresh process: no term
    interned, no derivative cached, no automaton cached.  Its automata
    depend on the order in which the process first interned their terms
    (`reef_tpu/frontend/regex.py` `_mk`), so one that earlier tests in the
    same process touched can differ from the one its CLI builds alone, the
    one the port's CLI builds."""
    from reef_tpu import cli as ref_cli
    from reef_tpu.frontend import regex as ref_regex
    ref_regex._TABLE.clear()
    ref_regex._COUNTER[0] = 0
    ref_regex._DERIV_CACHE.clear()
    ref_regex._BOUNDS_CACHE.clear()
    ref_cli._SAFA_CACHE.clear()


def cross_verify(monkeypatch, argv, prover: str, resume_after: int = 0,
                 device_sumcheck: bool = True) -> None:
    """One side commits and proves, the other verifies; `argv` are the
    port's `--e2e` arguments with `--device cpu` (the JAX package's CLI
    takes the same without `--device`).  The port proves with every
    nlookup batch on its device route (DEVICE_SUMCHECK_ONLY: the kernels'
    plain versions on the CPU; with `device_sumcheck` False, on the host)
    and its commits on the host, and verifies on its host routes; the JAX
    package runs on its host routes (REEF_DEVICE_MSM=0,
    REEF_DEVICE_SUMCHECK=0, which only it reads), with the regex terms of
    a fresh process (`fresh_reference_terms`).  With `resume_after` (argv hold
    `--checkpoint`), the first proof stops after that many checkpoints and
    a second one resumes from the last of them."""
    from reef_tpu import cli as ref_cli
    from reef_tpu.utils import serialize as ref_serialize
    from reef_tpu_torch import cli
    from reef_tpu_torch.ops import sumcheck_device
    from reef_tpu_torch.utils import device, serialize

    i = argv.index("--device")
    assert argv[i + 1] == "cpu"
    ref_argv = argv[:i] + argv[i + 2:]
    monkeypatch.setattr(device, "_SELECTED", None)
    monkeypatch.setenv("REEF_DEVICE_MSM", "0")
    monkeypatch.setenv("REEF_DEVICE_SUMCHECK", "0")
    fresh_reference_terms()
    if prover == "port":
        main, sz, prove_argv = cli.main, serialize, argv
        verify_main, verify_argv = ref_cli.main, ref_argv
    else:
        main, sz, prove_argv = ref_cli.main, ref_serialize, ref_argv
        verify_main, verify_argv = cli.main, argv
    rounds = []
    orig = sumcheck_device.device_sumcheck_rounds

    def counted(lf, cache, *a):
        rounds.append(cache.ell)
        return orig(lf, cache, *a)

    port_routes = (DEVICE_SUMCHECK_ONLY if prover == "port"
                   and device_sumcheck else routes.policy())
    with monkeypatch.context() as m, routes.use(port_routes):
        if prover == "port" and device_sumcheck:
            m.setattr(sumcheck_device, "device_sumcheck_rounds", counted)
        run_cli(main, _in_mode(prove_argv, "--commit"))
        if resume_after:
            with monkeypatch.context() as stop:
                _saves_then_stops(stop, sz, resume_after)
                with pytest.raises(RuntimeError, match="after a checkpoint"):
                    run_cli(main, _in_mode(prove_argv, "--prove"))
            ckpt = prove_argv[prove_argv.index("--checkpoint") + 1]
            assert os.path.exists(ckpt)
            out = run_cli(main, _in_mode(prove_argv, "--prove"))
            assert "resuming from checkpoint" in out, out
            assert not os.path.exists(ckpt)
        else:
            run_cli(main, _in_mode(prove_argv, "--prove"))
    assert prover == "ref" or not device_sumcheck or rounds, \
        "no nlookup batch of the port took the device route"
    out = run_cli(verify_main, _in_mode(verify_argv, "--verify"))
    assert "Verification PASSED" in out, out


# the sizes of the workloads' cross-verify cases: the 100 KB workloads at
# 2048 bytes, the others small (password and pihole ignore the size)
XV_SIZES = {"proj_hybrid": 2048, "unicode_proj": 2048, "unicode_mn": 2048,
            "merkle_negate": 2048, "dkim": 256, "zombie_date": 256,
            "unicode": 256, "password": 0, "pihole": 0}


def workload_cross_verifies(monkeypatch, tmp_path, name: str, prover: str
                            ) -> None:
    """`cross_verify` of one workload of `reef_tpu_torch.workloads` at its
    XV_SIZES size, in `tmp_path`."""
    from reef_tpu_torch import workloads
    monkeypatch.chdir(tmp_path)
    argv = workloads.argv_for(name, XV_SIZES[name], str(tmp_path),
                              device="cpu")
    cross_verify(monkeypatch, argv, prover)
