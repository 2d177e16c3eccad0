"""CLI options cross-verified between the port and the JAX package on the
CPU: `-b 3`, `--case-insensitive`, and the `snort` alphabet, which both
packages refuse alike (the reference's own is a stub).  A proof resumed
from a checkpoint is in `test_torch_workloads_checkpoint.py`."""

import pytest

from _torch_support import (cross_verify, no_compile_cache_writes,  # noqa: F401
                            one_torch_thread, run_cli)
from reef_tpu import cli as ref_cli
from reef_tpu_torch import cli

DOC = "Hello World, hello REEF reef"


def _argv(tmp_path, regex, *flags):
    (tmp_path / "doc.txt").write_bytes(DOC.encode())
    return ["ascii", "--e2e", "-d", str(tmp_path / "doc.txt"), "-r", regex,
            *flags, "--device", "cpu"]


@pytest.mark.parametrize("prover", ["port", "ref"])
def test_batch_of_three_cross_verifies(monkeypatch, tmp_path, prover):
    monkeypatch.chdir(tmp_path)
    cross_verify(monkeypatch, _argv(tmp_path, "hello.*reef", "-b", "3"),
                 prover)


@pytest.mark.parametrize("prover", ["port", "ref"])
def test_case_insensitive_cross_verifies(monkeypatch, tmp_path, prover):
    monkeypatch.chdir(tmp_path)
    argv = _argv(tmp_path, "^hello world.*reef$", "--case-insensitive")
    cross_verify(monkeypatch, argv, prover)


@pytest.mark.parametrize("side", ["port", "ref"])
@pytest.mark.parametrize("mode", ["--commit", "--verify"])
def test_snort_is_refused_alike(monkeypatch, tmp_path, capsys, side, mode):
    monkeypatch.chdir(tmp_path)
    argv = ["snort", mode, "-d", "doc.txt", "-r", ".*"]
    (tmp_path / "doc.txt").write_text(DOC)
    main = cli.main if side == "port" else ref_cli.main
    with pytest.raises(SystemExit) as e:
        run_cli(main, argv + (["--device", "cpu"] if side == "port" else []))
    assert e.value.code == 1
    assert "snort alphabet is a stub" in capsys.readouterr().err
    assert sorted(p.name for p in tmp_path.iterdir()) == ["doc.txt"]
