"""Seconds a prove request spends in the device sumcheck route
(`ops/sumcheck_device.py` `device_sumcheck_rounds`, which runs
`sharded_rounds`), from a synchronise to a synchronise."""


def read(run):
    return run.route_mean("prove", "sumcheck")
