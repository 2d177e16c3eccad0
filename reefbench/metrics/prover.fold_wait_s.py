"""Seconds a prove request's solver waits on the fold worker: blocked on
the bounded queue's `put` and on the worker's `join`
(`backend/framework.py` `run_prover`), the port's span `Solver
wait_fold`.  Spans in helper threads add up across threads, so the two
Spartan proofs can together read more than `prover.snark_s`'s wall time."""


def read(run):
    return run.stage_mean("prove", "Solver", "wait_fold")
