"""The lane cell (``sarcos-lanes``) end to end on the CPU at a tiny size:
a whole run is correct, traced and untraced, and the control and the
three faults of :mod:`benchmark.lane_faults` are not.

The tiny runs train in float64: at M 8 the recognition GP's gradients
sit near Adam's eps (21 inputs, kernels far below 1), so a float32
program's ``change`` reads float32's own rounding there (the plain
float32 reference reads the same, 1e-3 to 3e-2); the cell's float32
limits are read on the card at its widths (``benchmark/calibrate_lanes.py``)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness, lane_faults
from benchmark.mixes import lanes
from benchmark.reference import common

TINY = {"model": {"batch_size": 2, "samples": 3, "ind_pnt_num": 8, "recog_len": 4,
                  "dtype": "float64"},
        "data": {"seq_len": 40, "seq_stride": 500, "train_windows": 10, "test_windows": 4},
        "reproduction": {"iterations": 3}, "gp_predict": {"l": 3},
        "traffic": {"trace_steps": 5}}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_lane_cell_runs_end_to_end_on_the_cpu(trace):
    out = harness.execute("sarcos-lanes", 2 ** 31 + 4242, 0.5, bool(trace), device="cpu",
                          overrides=TINY)
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = harness.Cell("sarcos-lanes")
    if trace:
        # the card's trace gives the others; the CPU's the spans and the rate
        assert {"mfu.lanes", "forward_host_ms_per_step.lanes", "backward_host_ms_per_step.lanes",
                "optimizer_host_ms_per_step.lanes"} == set(out["metrics"])
        assert all(out["metrics"][k]["value"] > 0 for k in out["metrics"])
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.metrics("end_to_end")}
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("fault", sorted(lane_faults.FAULTS))
def test_a_broken_lane_step_is_not_correct(fault):
    with lane_faults.planted(lane_faults.FAULTS[fault]):
        out = harness.execute("sarcos-lanes", 91, 0.5, False, device="cpu", overrides=TINY)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["grad"]["value"] > out["checks"]["grad"]["limit"]


def test_the_control_fails_the_limits():
    """The reference in TF32 in the program's place is not correct under
    the cell's limits."""
    cell = harness.Cell("sarcos-lanes", overrides=dict(TINY, model=dict(TINY["model"],
                                                                        dtype="float32")))
    run = lanes.Run(cell, 20261019, "cpu")
    run.make_inputs()
    ref = run.reference(common.Precision(torch.float64))
    ctl = run.reference(common.Precision(torch.float32, tf32=True))
    run.close()
    check = harness.checks(lanes.compare(ctl, ref), cell.cfg["limits"])
    assert not harness.passed(check), check


def test_the_roofline_reader_holds_the_launches_to_the_reckoning():
    read = harness.metric_reader("gp_predict_lanes_roofline.lanes")
    cfg = harness.Cell("sarcos-lanes").cfg
    name = "void gp_predict_kernel<float, true>(...)"
    summary = {"busy_s": 1.0, "cfg": cfg, "train_steps": 2, "eval_batches": 1,
               "device_ops_by_name": {name: [3 * 281, 0.05]}, "lane_launches": 3 * 281}
    share = read(summary)
    assert 0 < share < 100
    with pytest.raises(RuntimeError):
        read(dict(summary, lane_launches=3 * 281 - 1))
    with pytest.raises(RuntimeError):
        read(dict(summary, train_steps=3))


def test_the_lane_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.sarcos, benchmark.reference.lanes\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", "import json\n" + code], capture_output=True,
                         text=True, check=True, cwd="/")
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in top
    assert not top & {"cbfssm_tpu_torch", "cbfssm_tpu", "jax", "jaxlib", "flax"}
