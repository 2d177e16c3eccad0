"""Seconds a prove request spends on the host side of the device MSM
route (`ec/msm_v3.py`): the scalars to bytes, their upload, and the
read-back and window combine (which holds the wait for the kernels): the
port's spans `MSM scalars`, `MSM upload` and `MSM combine`, summed.
Spans in helper threads add up across threads, so the two Spartan proofs
can together read more than `prover.snark_s`'s wall time."""

STAGES = ("scalars", "upload", "combine")


def read(run):
    parts = [run.stage_mean("prove", "MSM", s) for s in STAGES]
    if all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts)
