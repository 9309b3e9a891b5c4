"""Host milliseconds a lane step spends in the program's ``step.backward``
spans (self time, over the traced run's untraced epochs, per ``step``
span): :func:`benchmark.spans.per_step` on the lane cell's summary.
Nothing on a program without spans."""

from benchmark import spans


def read(summary):
    return spans.per_step(summary).get("backward_host_ms_per_step.train")
