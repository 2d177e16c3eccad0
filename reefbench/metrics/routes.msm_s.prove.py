"""Seconds a prove request spends in the device MSM route
(`PedersenGens._msm_device_route`: `ec/msm_v3.py` `msm_device_v3`, or
`parallel/mesh.py` `sharded_msm` on several cards; and
`msm_device_v3_rows`), from a synchronise to a synchronise."""


def read(run):
    return run.route_mean("prove", "msm")
