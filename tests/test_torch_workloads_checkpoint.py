"""A proof stopped after a checkpoint and resumed (`--checkpoint` with
`-b 2`), cross-verified between the port and the JAX package on the
CPU."""

import pytest

from _torch_support import (cross_verify, no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)


@pytest.mark.parametrize("prover", ["port", "ref"])
def test_checkpoint_resume_cross_verifies(monkeypatch, tmp_path, prover):
    """Five folds of two characters, a checkpoint every two folds: the
    first proof stops after the first checkpoint, the second resumes."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "doc.txt").write_bytes(b"hello reef")
    argv = ["ascii", "--e2e", "-d", str(tmp_path / "doc.txt"), "-r",
            "hello.*reef", "-b", "2", "--checkpoint",
            str(tmp_path / "prove.ckpt"), "--checkpoint-every", "2",
            "--device", "cpu"]
    cross_verify(monkeypatch, argv, prover, resume_after=1)
