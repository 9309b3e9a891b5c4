"""Share of a lane step's wall time in which no operation runs on the
device: the arithmetic of ``device_idle_pct.train`` (traced device time
a step over the untraced step time) on the lane cell's summary."""

from benchmark import harness


def read(summary):
    return harness.metric_reader("device_idle_pct.train")(summary)
