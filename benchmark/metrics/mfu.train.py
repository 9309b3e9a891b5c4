"""Share of the card's float32 peak (67 TFLOP/s, CUDA cores: the
configuration runs IEEE float32, TF32 off) that the analytic model
operations reach at the untraced step time: a train step's GP-link
matmuls x3 (forward and backward) and its share of the test batches'
x1 (the traced span's ratio of test batches to steps), over the
wall time a step takes in the run's untraced epochs (``step_s``, the
test pass included), so that the profiler's cost is not in it."""

from benchmark.yardstick import PEAK_FLOPS


def read(summary):
    if not summary.get("step_s") or not summary.get("train_steps"):
        return None
    gflop = summary["gflop_per_step"] * (1.0 + summary["eval_batches"]
                                         / (3.0 * summary["train_steps"]))
    peak = PEAK_FLOPS[summary["cfg"]["model"]["dtype"]]
    return 100.0 * gflop * 1e9 / summary["step_s"] / peak
