"""The `.cmt`/`.proof` pairs of tests/data/card_pairs.json, held to both
packages' verifiers on the CPU.

`tools/card_pairs.py` made them: seven on an H100, the party roles each in
a process of its own (commit, prove, verify; one prover killed at its
first checkpoint and resumed by a second), the device routes on `auto`;
four with the JAX package's CLI on the CPU.  Here:

  * each pair's bytes match their sha256, and no prover secret is kept;
  * each card-made prove process launched the kernels of its floors, and
    the killed prover resumed;
  * `reef_tpu.cli --verify` (JAX on the CPU, with the regex terms of a
    fresh process) accepts every card-made pair;
  * one byte flipped in each card-made `.proof`, its checksum made good
    again, is refused by both packages' `--verify` alike.

The port's verifier on every pair is in
`test_torch_pairs_from_card_port.py`, the proofs' own leaves mutated in
`test_torch_pairs_from_card_leaves.py`.  Proofs are randomised, so no
test compares proof bytes: each compares what the verifiers decide.
"""

import random

import pytest

from _torch_support import (cli_verdict,  # noqa: F401
                            device_selection_restored,
                            fresh_reference_terms, no_compile_cache_writes,
                            one_torch_thread, pair_id, repo_module,
                            resealed)
from reef_tpu import cli as ref_cli
from reef_tpu_torch import cli

CP = repo_module("tools/card_pairs.py")
PAIRS = CP.load()["pairs"]
CARD = [p for p in PAIRS if p["made_by"] == "reef_tpu_torch"]


def test_the_file_holds_every_case_of_both_makers():
    got = {(p["made_by"], p["name"]) for p in PAIRS}
    want = {("reef_tpu_torch", n) for n in CP.CASES} | \
        {("reef_tpu", n) for n in CP.REFERENCE_CASES}
    assert got == want
    makers = CP.load()["makers"]
    card = makers["reef_tpu_torch"]["card"]
    assert "H100" in card and card.endswith(" W"), card
    for maker in makers.values():
        assert CP.REV.match(maker["rev"]), maker


@pytest.mark.parametrize("pair", PAIRS, ids=pair_id)
def test_pair_matches_its_sha256(pair):
    assert {"cmtkey", "cmtkey_sha256"}.isdisjoint(pair)
    for ext in ("cmt", "proof"):
        assert CP.pair_bytes(pair, ext)
    bad = dict(pair, proof=pair["cmt"])
    with pytest.raises(ValueError, match="sha256"):
        CP.pair_bytes(bad, "proof")


@pytest.mark.parametrize("pair", CARD, ids=pair_id)
def test_card_prove_process_met_its_floors(pair):
    """K2 and K1's reduce in every prove process, K5's block-per-state
    launch and K6 where a table ran on the card; the CLI's own device
    (cuda); the argv of the case table; in the resumed case K2 and K1's
    reduce in the killed process before its checkpoint."""
    spec = CP.CASES[pair["name"]]
    assert CP.refusals(spec, pair) == []
    assert pair["table"] == bool(spec.get("table"))
    assert pair["argv"] == CP.role_argvs(pair["name"], spec)
    if spec.get("resume"):
        assert pair["resume"]["exit_code"] == -9
        assert pair["resume"]["folds_done"] >= CP.RESUME_MIN_FOLDS


@pytest.mark.parametrize("pair", CARD, ids=pair_id)
def test_reference_verifier_accepts_card_pair(tmp_path, capsys, pair):
    fresh_reference_terms()
    argv = CP.verify_argv(pair, str(tmp_path))
    assert cli_verdict(ref_cli.main, argv, capsys) == "passed"


@pytest.mark.parametrize("pair", CARD, ids=pair_id)
def test_flipped_proof_byte_refused_by_both(tmp_path, capsys,
                                           device_selection_restored, pair):
    """A seeded bit of the proof's body flipped and its checksum made good
    again: each package's `--verify` refuses it, alike."""
    argv = CP.verify_argv(pair, str(tmp_path))
    path = argv[argv.index("--proof-name") + 1]
    data = CP.pair_bytes(pair, "proof")
    rng = random.Random(pair["proof_sha256"])
    b = bytearray(data)
    b[rng.randrange(len(data) - 16)] ^= 1 << rng.randrange(8)
    with open(path, "wb") as fh:
        fh.write(resealed(bytes(b)))
    got = cli_verdict(cli.main, argv + ["--device", "cpu"], capsys)
    fresh_reference_terms()
    want = cli_verdict(ref_cli.main, argv, capsys)
    assert got != "passed" and got == want, (got, want)
