"""Seconds a prove request spends on the compressed SNARK
(`backend/spartan.py`, `backend/ipa.py`): the port's `--metrics` timer
`Prover compressed_snark`."""


def read(run):
    return run.stage_mean("prove", "Prover", "compressed_snark")
