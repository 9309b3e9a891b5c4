"""Share of the card's float32 peak that a lane step's analytic model
operations reach at the untraced step time: the arithmetic of
``mfu.train`` on the lane cell's summary, whose ``gflop_per_step`` is
every lane's (L x the reference's ``gflop_per_step``)."""

from benchmark import harness


def read(summary):
    return harness.metric_reader("mfu.train")(summary)
