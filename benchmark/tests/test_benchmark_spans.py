"""``benchmark/spans.py``: the program's spans laid over a hand-built
trace, worked out by hand; the existing summary, readers and breakdown
unchanged beside the spans' keys; and a traced run of a cell with spans
on, on the CPU at a tiny size, through ``scripts/torch_trainer_spans.py``."""

import importlib.util
import os
from pathlib import Path

import pytest
import torch

from benchmark import harness, spans, tracing

ROOT = Path(__file__).resolve().parents[2]
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
PHASES = {"data.batch": "data", "step.forward": "forward", "step.backward": "backward",
          "step.optimizer": "optimizer", "eval.loss": "eval", "trainer.readback": "bookkeeping",
          "trainer.train": "bookkeeping", "trainer.epoch": "bookkeeping",
          "step": "bookkeeping"}


class Event:
    """A ``_KinetoEvent`` of the methods the summaries call."""

    def __init__(self, name, device, start, end, corr=0, annotation=False):
        self._v = (name, device, start, end, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


# one epoch of two steps (ns); "benchmark.trace_stop" has no phase: cut out
SPANS = [
    ("trainer.train", None, 60, 1000),       # 0
    ("trainer.epoch", 0, 100, 900),          # 1
    ("data.batch", 1, 110, 130),             # 2
    ("step", 1, 130, 330),                   # 3
    ("step.optimizer", 3, 135, 140),         # 4
    ("step.forward", 3, 140, 200),           # 5
    ("step.backward", 3, 200, 300),          # 6
    ("step.optimizer", 3, 300, 320),         # 7
    ("data.batch", 1, 330, 400),             # 8
    ("benchmark.trace_stop", 8, 350, 390),   # 9
    ("step", 1, 400, 600),                   # 10
    ("step.optimizer", 10, 400, 410),        # 11
    ("step.forward", 10, 410, 480),          # 12
    ("step.backward", 10, 480, 560),         # 13
    ("step.optimizer", 10, 560, 590),        # 14
    ("eval.loss", 1, 620, 700),              # 15
    ("trainer.readback", 1, 700, 880),       # 16
]

# the launch calls' starts (ns): forward x2, backward, optimizer, forward,
# backward x2, optimizer, eval, and one before every span
LAUNCHES = [150, 170, 210, 305, 450, 500, 520, 565, 630, 50]


def trace_events():
    events = [Event("ProfilerStep#1", CPU, 0, 1000)]
    for k, t in enumerate(LAUNCHES, start=1):  # correlation ids 1..
        events.append(Event("cudaLaunchKernel", CPU, t, t + 4, corr=k))
        # the backward's kernels come from autograd's thread: only the
        # correlation id ties them to their call
        events.append(Event(f"kernel_{k}", CUDA, t + 20, t + 30, corr=k))
    events += [
        Event("kernel_without_call", CUDA, 700, 710, corr=99),
        Event("Memcpy HtoD", CUDA, 720, 760, corr=98),
        Event("cudaMemcpyAsync", CPU, 715, 725, corr=98),
        Event("step.forward", CUDA, 140, 200, annotation=True),
        Event("cudaStreamSynchronize", CPU, 860, 995),
    ]
    return events


def test_host_self_time_by_phase_and_steps_by_hand():
    own = spans.self_intervals(SPANS)
    assert own[3] == [(130, 135), (320, 330)]
    assert own[8] == [(330, 350), (390, 400)]  # the cut-out child is not data's
    got = spans.host_ns_by_phase(SPANS, PHASES, [(0, 1000)])
    # bookkeeping: train 40 + 100, epoch 10 + 20 + 20, steps 15 + 10, readback 180
    assert got == {"data": 20 + 30, "forward": 60 + 70, "backward": 100 + 80,
                   "optimizer": 5 + 20 + 10 + 30, "eval": 80,
                   "bookkeeping": 140 + 50 + 25 + 180}
    assert sum(got.values()) + 40 == 1000 - 60  # every ns of the spans but the cut-out one's
    # a stretch that ends inside the second step's forward
    part = spans.host_ns_by_phase(SPANS, PHASES, [(0, 450)])
    assert part["forward"] == 60 + 40 and part["backward"] == 100
    assert spans.count_in(SPANS, "step", [(0, 450)]) == 2
    assert spans.count_in(SPANS, "step", [(0, 399)]) == 1
    assert spans.count_in(SPANS, "step", [(0, 120), (390, 1000)]) == 1


def test_kernels_go_to_the_span_open_at_their_launch_call():
    events = trace_events()
    got = spans.kernels_by_phase(events, SPANS, PHASES)
    # launched at 50, before the spans, and a kernel with no call
    assert got == {"forward": 3, "backward": 3, "optimizer": 2, "eval": 1, spans.OUTSIDE: 2}
    assert sum(got.values()) == tracing.summarize(events, 1e-6)["kernels"] == 11


def test_every_idle_gap_goes_to_the_span_open_when_it_began():
    """Busy: each kernel's [t + 20, t + 30], 700-710 and the copy 720-760,
    between the first and last event (50, 995): 795 ns of gaps."""
    events = trace_events()
    got = spans.idle_by_span(events, SPANS, PHASES)
    want = {spans.OUTSIDE: [1, 20], "trainer.train": [1, 90], "step.forward": [1, 10],
            "step.backward": [5, 30 + 85 + 40 + 10 + 35], "data.batch": [1, 135],
            "step": [1, 55], "eval.loss": [1, 40], "trainer.readback": [2, 10 + 235]}
    assert got.keys() == want.keys()
    for name, (n, ns) in want.items():
        assert got[name][0] == n and got[name][1] == pytest.approx(ns / 1e9, rel=1e-12), name
    summary = tracing.summarize(events, 1e-6)
    idle = (995 - 50) / 1e9 - summary["busy_s"]
    assert sum(v[1] for v in got.values()) == pytest.approx(idle, rel=1e-12)
    folded = spans.idle_spans({"span_idle": got}, PHASES)
    assert [k for k, _ in folded] == ["bookkeeping", "backward", "data", "eval",
                                      spans.OUTSIDE, "forward"]
    assert folded[0][1] == pytest.approx((90 + 55 + 245) / 1e9, rel=1e-12)


def summary_of(events):
    """``tracing.summarize`` and the keys the training mix adds."""
    summary = tracing.summarize(events, 1e-6)
    cfg = {"model": {"dtype": "float32"},
           "gp_predict": {"kernel": "kernel_",
                          "train_step": [{"n": 8, "m": 4, "di": 2, "d": 1, "residuals": True,
                                          "count": 5}],
                          "eval_batch": [{"n": 8, "m": 4, "di": 2, "d": 1, "residuals": False,
                                          "count": 1}]}}
    summary.update(train_steps=2, eval_batches=1, step_s=2e-6, gflop_per_step=1e-9, cfg=cfg)
    return summary


def test_the_spans_keys_leave_the_summary_readers_and_breakdown_as_they_were():
    events = trace_events()
    base = summary_of(events)
    extra = spans.summarize(SPANS, PHASES, [(0, 1000)], events)
    assert not set(extra) & set(base)
    merged = dict(base, **extra)
    names = ["kernels_per_step.train", "device_ms_per_step.train", "device_idle_pct.train",
             "gp_predict_roofline.train", "mfu.train"]
    values = [harness.metric_reader(n)(base) for n in names]
    assert None not in values
    assert [harness.metric_reader(n)(merged) for n in names] == values
    assert tracing.breakdown(merged) == tracing.breakdown(base)
    assert tracing.summarize(events, 1e-6).keys() == set(base) - {
        "train_steps", "eval_batches", "step_s", "gflop_per_step", "cfg"}
    per = spans.per_step(merged)
    assert per == pytest.approx({
        "data_host_ms_per_step.train": 50e-6 / 2, "forward_host_ms_per_step.train": 130e-6 / 2,
        "backward_host_ms_per_step.train": 180e-6 / 2,
        "optimizer_host_ms_per_step.train": 65e-6 / 2, "eval_host_ms_per_step.train": 80e-6 / 2,
        "bookkeeping_host_ms_per_step.train": 395e-6 / 2,
        "forward_kernels_per_step.train": 1.5, "backward_kernels_per_step.train": 1.5,
        "optimizer_kernels_per_step.train": 1.0}, rel=1e-12)
    assert spans.per_step(base) == {}  # a program without spans: nothing, no error


def test_a_traced_run_with_spans_on_the_cpu():
    """The measurement script's traced run of a tiny cell: the six host
    phases a step over the untraced epochs cover the step time, and the
    traced epochs hold the steps and test batches the feed counted."""
    path = ROOT / "scripts" / "torch_trainer_spans.py"
    spec = importlib.util.spec_from_file_location("torch_trainer_spans", path)
    script = importlib.util.module_from_spec(spec)
    environ = dict(os.environ)
    try:  # the script takes the benchmark's settings from benchmark/run.py
        spec.loader.exec_module(script)
    finally:
        os.environ.clear()
        os.environ.update(environ)
    out = script.traced_run("voliro-train", 2 ** 31 + 99, 0.5, "cpu", script.TINY["voliro-train"])
    assert out["correct"] is True
    host = {k: v for k, v in out["per_step"].items() if "_host_ms_" in k}
    assert set(host) == {f"{p}_host_ms_per_step.train" for p in spans.HOST_PHASES}
    assert all(v >= 0 for v in host.values()) and host["backward_host_ms_per_step.train"] > 0
    assert out["host"]["sum_over_step"] == pytest.approx(1.0, abs=0.05)
    assert out["traced_steps_in_spans"] == out["train_steps"] > 0
    assert out["eval_spans_traced"] == out["eval_batches"] > 0
    assert out["kernels_sum"] == out["kernels"]  # no kernels in a CPU trace: 0 == 0
