"""Seconds a prove request spends in the batched opening of
`backend/spartan.py` `spartan_prove` (its sumcheck and the IPA,
`backend/ipa.py`), in every Spartan proof (the compressed SNARK's two
and the CAP's): the port's span `Prover spartan.open`.  Spans in helper
threads add up across threads, so the two Spartan proofs can together
read more than `prover.snark_s`'s wall time."""


def read(run):
    return run.stage_mean("prove", "Prover", "spartan.open")
