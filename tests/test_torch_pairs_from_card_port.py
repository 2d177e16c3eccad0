"""The port's verifier (`reef_tpu_torch.cli --verify --device cpu`) on
every pair of tests/data/card_pairs.json: those made on the H100 by the
port and those made on the CPU by the JAX package
(`test_torch_pairs_from_card.py` has the rest of this lane)."""

import pytest

from _torch_support import (cli_verdict,  # noqa: F401
                            device_selection_restored, one_torch_thread,
                            pair_id, repo_module)
from reef_tpu_torch import cli

CP = repo_module("tools/card_pairs.py")
PAIRS = CP.load()["pairs"]


@pytest.mark.parametrize("pair", PAIRS, ids=pair_id)
def test_port_verifier_accepts_pair(tmp_path, capsys,
                                    device_selection_restored, pair):
    argv = CP.verify_argv(pair, str(tmp_path)) + ["--device", "cpu"]
    assert cli_verdict(cli.main, argv, capsys) == "passed"
