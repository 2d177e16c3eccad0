"""Seconds of a prove request in Python's cyclic garbage collector, on
whichever thread triggered each collection: the port's span `Host gc`,
from a `gc.callbacks` hook.  Spans in helper threads add up across
threads, so the two Spartan proofs can together read more than
`prover.snark_s`'s wall time."""


def read(run):
    return run.stage_mean("prove", "Host", "gc")
