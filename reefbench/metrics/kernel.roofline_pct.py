"""The kernels' share of their roofline over the window: the least time
the card could take for the work of every launch (`counts/`, priced by
`harness/peaks.py`), over the device time of those kernels in the
profiler's trace, in percent."""


def read(run):
    return run.device["roofline_pct"]
