"""The share of the window in which no operation ran on the card, from
the profiler's trace (the window less the union of busy intervals),
averaged over the cell's cards, in percent."""


def read(run):
    d = run.device
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
