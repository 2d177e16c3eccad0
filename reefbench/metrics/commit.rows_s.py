"""Seconds a commit request spends committing the document's Hyrax rows
(`backend/commitment.py` `HyraxPC.commit`, the native host row MSMs
below the device rows' floor): the port's span `CommitmentGen rows`.
Spans in helper threads add up across threads, so the two Spartan proofs
can together read more than `prover.snark_s`'s wall time."""


def read(run):
    return run.stage_mean("commit", "CommitmentGen", "rows")
