"""Seconds a verify request spends checking the SNARKs
(`framework.run_verifier`): the port's `--metrics` timer
`Verifier snark_verification`."""


def read(run):
    return run.stage_mean("verify", "Verifier", "snark_verification")
