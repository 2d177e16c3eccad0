"""The proof modes `-p` (projections) and `-y` (hybrid) each alone,
cross-verified between the port and the JAX package on the CPU, both
ways, the port on its device-sumcheck route (`_torch_support.cross_verify`).
Together they are in tests/test_torch_e2e.py."""

import pytest

from _torch_support import (cross_verify, no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)

# (alphabet, document, regex, flags)
MODES = {
    "projections": ("dna", "A" * 36 + "ACGT", "^.{36}ACGT$", ["-p"]),
    "hybrid": ("dna", "ACGTTGCAAC", ".*TTG.*", ["-y"]),
}


@pytest.mark.parametrize("prover", ["port", "ref"])
@pytest.mark.parametrize("mode", list(MODES))
def test_mode_alone_cross_verifies(monkeypatch, tmp_path, mode, prover):
    monkeypatch.chdir(tmp_path)
    ab, doc, rx, flags = MODES[mode]
    (tmp_path / "doc.txt").write_text(doc)
    argv = [ab, "--e2e", "-d", str(tmp_path / "doc.txt"), "-r", rx, *flags,
            "--device", "cpu"]
    cross_verify(monkeypatch, argv, prover)
