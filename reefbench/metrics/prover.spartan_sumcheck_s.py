"""Seconds a prove request spends in the two sumchecks of
`backend/spartan.py` `spartan_prove` (the first with the matrix-vector
products before it), in every Spartan proof (the compressed SNARK's two
and the CAP's): the port's spans `Prover spartan.sumcheck1` and `Prover
spartan.sumcheck2`, summed.  Spans in helper threads add up across
threads, so the two Spartan proofs can together read more than
`prover.snark_s`'s wall time."""


def read(run):
    parts = [run.stage_mean("prove", "Prover", f"spartan.sumcheck{i}")
             for i in (1, 2)]
    if all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts)
