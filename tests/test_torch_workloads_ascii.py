"""Four of the suite's workloads cross-verified between the port and the
JAX package on the CPU (`test_torch_workloads.py` has the table and the
others): the reference scripts' ascii ones, and `unicode_proj`."""

import pytest

from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread, workload_cross_verifies)


@pytest.mark.parametrize("prover", ["port", "ref"])
@pytest.mark.parametrize("name", ["password", "zombie_date", "dkim",
                                  "unicode_proj"])
def test_workload_cross_verifies(monkeypatch, tmp_path, name, prover):
    workload_cross_verifies(monkeypatch, tmp_path, name, prover)
