"""Device kernels a training step launches: the kernels of the traced
span (its train steps with their share of test batches and block
bookkeeping) over the train steps in it."""


def read(summary):
    if not summary.get("kernels") or not summary.get("train_steps"):
        return None
    return summary["kernels"] / summary["train_steps"]
