"""Seconds a prove request spends preparing its nlookup tables for the
sumcheck route each takes (`backend/witness.py` `_fill_nl`: the device
table built and encoded on the card or the mesh, or the host Montgomery
table on the host route; a cache hit for each later batch), the port's
span `Solver nl_table`, inside `Solver solve`.  A port without the span
reads nothing."""


def read(run):
    return run.stage_mean("prove", "Solver", "nl_table")
