"""Share of a training step's wall time in which no operation runs on
the device: 1 - the device time a step takes in the traced span (the
union of device-operation intervals over its train steps, its test
batches included) over the wall time a step takes in the run's untraced
epochs (``step_s``), so that the profiler's cost is not in it."""


def read(summary):
    if not summary.get("busy_s") or not summary.get("train_steps") or not summary.get("step_s"):
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["train_steps"] / summary["step_s"])
