"""The character transforms `--alpha-numeric`, `--basic-english` and
`--ignore-whitespace`, cross-verified between the port and the JAX
package on the CPU, both ways, the port on its device-sumcheck route
(`_torch_support.cross_verify`).  `--case-insensitive` is in
tests/test_torch_workloads_options.py."""

import pytest

from _torch_support import (cross_verify, no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)

DOC = "Hello World, hello REEF reef!"
# flag -> a regex over the document as the transform leaves it
TRANSFORMS = {
    "--alpha-numeric": "^HelloWorld.*REEFreef$",
    "--basic-english": "World, hello.*reef!$",
    "--ignore-whitespace": "^Hello.*,hello.*reef!$",
}


@pytest.mark.parametrize("prover", ["port", "ref"])
@pytest.mark.parametrize("flag", list(TRANSFORMS))
def test_transform_cross_verifies(monkeypatch, tmp_path, flag, prover):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "doc.txt").write_text(DOC)
    argv = ["ascii", "--e2e", "-d", str(tmp_path / "doc.txt"), "-r",
            TRANSFORMS[flag], flag, "--device", "cpu"]
    cross_verify(monkeypatch, argv, prover)
