"""Device kernels a lane step launches (one lane-batched Adam step of
every lane, with its share of test batches and bookkeeping): the
arithmetic of ``kernels_per_step.train`` on the lane cell's summary."""

from benchmark import harness


def read(summary):
    return harness.metric_reader("kernels_per_step.train")(summary)
