"""Seconds a verify request spends checking the IVC proof
(`backend/ivc.py` `verify`: the state hashes, the last fold and the two
Spartan verifications) in its own thread: the port's span `Verifier
ivc_check`.  Spans in helper threads add up across threads, so the two
Spartan proofs can together read more than `prover.snark_s`'s wall time."""


def read(run):
    return run.stage_mean("verify", "Verifier", "ivc_check")
