"""Device milliseconds a training step: the union of device-operation
intervals in the traced span over the train steps in it."""


def read(summary):
    if not summary.get("busy_s") or not summary.get("train_steps"):
        return None
    return 1e3 * summary["busy_s"] / summary["train_steps"]
