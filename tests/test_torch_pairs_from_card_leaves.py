"""The card-made `-m -n` and `-p -y` proofs of tests/data/card_pairs.json,
their own int leaves mutated: both packages' verifiers must refuse each
mutant alike, on the CPU.

A seeded sample of LEAVES[case] int leaves of each proof (the walk of
chip_smoke.py's `int_leaves`: the IVC instances, both Spartan proofs and
their IPA openings, and the `-p -y` proof's consistency proof and CAP),
each mutated twice: plus one, and plus a seeded element of the base
field.  The port's `run_verifier` takes the mutated object; the
reference's takes it written by the port's codec and read by its own (a
value the writer will not encode is refused by both), as in
`test_torch_adversarial.py`.  A verifier refuses by returning False or
raising its package's VerifyError; any other exception fails the test.
"""

import random
import types

import pytest
import torch

from _torch_support import (fresh_reference_terms,  # noqa: F401
                            no_compile_cache_writes, one_torch_thread,
                            repo_module, verdict)
from reef_tpu import cli as ref_cli
from reef_tpu import errors as ref_errors
from reef_tpu.backend import framework as ref_fw
from reef_tpu.utils import serialize as ref_sz
from reef_tpu_torch import cli, errors
from reef_tpu_torch.backend import framework as FW
from reef_tpu_torch.ops import field as F
from reef_tpu_torch.utils import device
from reef_tpu_torch.utils import serialize as sz

# a proof's leaves sampled, each with both deltas: fewer of the -m -n
# proof, whose mutants take the verifiers several times as long, so that
# the file stays within about a minute of one test worker
LEAVES = {"merkle_negate": 5, "proj_hybrid": 12}
SEED = 20261017
DELTAS = ("one", "field element")


_CS = repo_module("chip_smoke.py")
CP = repo_module("tools/card_pairs.py")


def _args(pair):
    """The CLI's parsed arguments, as far as its alphabet and automaton
    read them."""
    flags = pair["flags"]
    return types.SimpleNamespace(
        alphabet=pair["alphabet"], re=pair["regex"], negate="-n" in flags,
        alpha_numeric=False, basic_english=False, ignore_whitespace=False,
        case_insensitive=False)


class Card:
    """One card-made pair as both packages read it, and its sample."""


def _card(name: str) -> Card:
    pair = next(p for p in CP.load()["pairs"]
                if p["made_by"] == "reef_tpu_torch" and p["name"] == name)
    c = Card()
    c.name = name
    flags = pair["flags"]
    c.kw = dict(batch_size=pair["batch"], projections="-p" in flags,
                hybrid="-y" in flags, merkle="-m" in flags)
    cmt, proof = (CP.pair_bytes(pair, e) for e in ("cmt", "proof"))
    c.commit, c.proofs = sz.loads(cmt, "cmt"), sz.loads(proof, "proof")
    c.ref_commit = ref_sz.loads(cmt, "cmt")
    args = _args(pair)
    c.safa = cli.build_safa(args, cli.build_alphabet(args))
    fresh_reference_terms()
    c.ref_safa = ref_cli.build_safa(args, ref_cli.build_alphabet(args))
    assert port_verdict(c, c.proofs) == "accept"
    assert ref_verdict(c, c.proofs) == "accept"
    rng = random.Random(f"{SEED}/{name}")
    leaves = [pth for pth, _ in _CS.int_leaves(c.proofs)]
    assert len(leaves) > 200, f"leaf walk too shallow: {len(leaves)}"
    c.sample = [(pth, {"one": 1, "field element": rng.randrange(1, F.P)})
                for pth in rng.sample(leaves, LEAVES[name])]
    return c


@pytest.fixture(scope="module")
def cards():
    """Each case's Card, built at its first use in the module."""
    built = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device, "_SELECTED", torch.device("cpu"))
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            yield lambda name: built.get(name) or built.setdefault(
                name, _card(name))
        finally:
            torch.set_num_threads(prev)


def port_verdict(c, proofs) -> str:
    return verdict(lambda: FW.run_verifier(c.commit, c.safa, proofs,
                                           **c.kw), errors.VerifyError)


def ref_verdict(c, proofs) -> str:
    """The reference's verdict on the port's object, written by the port's
    codec and read by the reference's; "refused by the writer" where the
    port's codec will not encode it."""
    try:
        data = sz.dumps("proof", proofs)
    except AssertionError:
        return "refused by the writer"
    return verdict(lambda: ref_fw.run_verifier(
        c.ref_commit, c.ref_safa, ref_sz.loads(data, "proof"), **c.kw),
        ref_errors.VerifyError)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("name,i", [
    (name, i) for name, n in LEAVES.items() for i in range(n)])
def test_mutated_card_proof_refused_by_both(cards, name, i, delta):
    card = cards(name)
    pth, deltas = card.sample[i]
    d = deltas[delta]
    p2 = _CS.with_leaf(card.proofs, pth, lambda v: v + d)
    assert port_verdict(card, p2) == "reject", (name, pth, delta)
    assert ref_verdict(card, p2) in ("reject", "refused by the writer"), \
        (name, pth, delta)
