"""Seconds a prove request spends in the solver on the request thread:
each step of `backend/witness.py` `solve_and_batch` (the automaton's
run, then each batch's witnesses and nlookup sumchecks), the port's span
`Solver solve`.  Spans in helper threads add up across threads, so the
two Spartan proofs can together read more than `prover.snark_s`'s wall
time."""


def read(run):
    return run.stage_mean("prove", "Solver", "solve")
