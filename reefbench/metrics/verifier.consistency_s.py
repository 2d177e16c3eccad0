"""Seconds a verify request spends checking the consistency proof, the
link from the proof's final document claim to the Hyrax commitment
(`backend/commitment.py`): the port's `--metrics` timer
`Verifier consistency_verification`."""


def read(run):
    return run.stage_mean("verify", "Verifier", "consistency_verification")
