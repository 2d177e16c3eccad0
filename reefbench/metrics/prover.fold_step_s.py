"""Seconds a prove request spends folding: the fold worker's
`backend/ivc.py` `RecursiveSNARK.prove_step` calls, the port's span
`Prover fold_step`.  Spans in helper threads add up across threads, so
the two Spartan proofs can together read more than `prover.snark_s`'s
wall time."""


def read(run):
    return run.stage_mean("prove", "Prover", "fold_step")
