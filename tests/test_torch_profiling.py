"""The port's ``trace``, spans and ``debug_nans`` (``utils/profiling.py``,
the counterparts of the JAX package's ``jax.profiler`` trace and
``jax_debug_nans`` switch) on the CPU. The Trainer's spans are pinned in
tests/test_torch_train.py."""

import glob
import itertools
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.utils import profiling
from cbfssm_tpu_torch.utils.profiling import debug_nans, record_spans, span, trace
from tests.test_trainer import SmokeDS, smoke_config


def test_trace_writes_a_trace_file_of_the_block(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.matmul(torch.ones(4, 4), torch.ones(4, 4))
    assert any(e.name == "aten::matmul" for e in prof.events())
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names


def test_debug_nans_raises_inside_the_block_only():
    x = torch.tensor([1.0, -1.0])
    with pytest.raises(FloatingPointError, match="sqrt"):
        with debug_nans():
            torch.sqrt(x)
    assert torch.isnan(torch.sqrt(x)).any()  # outside the block: no check
    with debug_nans():
        torch.sqrt(torch.abs(x))  # no NaN, no error


def test_debug_nans_raises_in_the_backward():
    """The forward is finite (0 * sqrt(0)); its gradient is 0 * inf."""
    x = torch.tensor([0.0], requires_grad=True)
    with debug_nans():
        y = torch.sum(torch.sqrt(x) * 0.0)
        with pytest.raises(FloatingPointError):
            y.backward()


def test_debug_nans_restores_the_previous_state():
    before = torch.is_anomaly_enabled()
    x = torch.tensor([-1.0])
    with debug_nans():
        assert torch.is_anomaly_enabled()
        with debug_nans(False):  # off inside an enclosing block
            assert torch.isnan(torch.sqrt(x)).all()
        with pytest.raises(FloatingPointError):
            torch.sqrt(x)
    assert torch.is_anomaly_enabled() == before
    assert torch.isnan(torch.sqrt(x)).all()


def test_debug_nans_passes_a_finite_training_step():
    model = CBFSSM(smoke_config(), device="cpu")
    ds = SmokeDS()
    params = model.init(torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_(True) for t in params.tensors()]
    with debug_nans():
        loss, _ = model.loss(params.with_tensors(leaves), ds.train_in_batch[:2],
                             ds.train_out_batch[:2], torch.Generator().manual_seed(1))
        loss.backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)


# --- spans -------------------------------------------------------------------


def test_span_off_is_one_shared_object_that_does_nothing(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("a span read the clock or called torch while off")

    for name in ("perf_counter_ns", "time_ns", "perf_counter"):
        monkeypatch.setattr(time, name, forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    first = span("a")
    assert first is span("b")
    with first as entered:
        with span("c"):
            pass
    assert entered is first and profiling._SPANS.records is None


@pytest.mark.parametrize("raised", [False, True])
def test_spans_nest_with_their_parents_and_self_time(monkeypatch, raised):
    """On a clock that advances 10 ns a read: each span's parent is the
    span open when it began, its interval holds its children's, and its
    self time is its length less theirs. A span left by an exception
    ends all the same."""
    clock = itertools.count(0, 10)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock))
    with record_spans() as spans:
        try:
            with span("outer"):
                with span("a"):
                    pass
                with span("b"):
                    with span("c"):
                        if raised:
                            raise KeyError("inside c")
        except KeyError:
            pass
        with span("after"):
            pass
    assert [(n, p) for n, p, _, _ in spans] == [
        ("outer", None), ("a", 0), ("b", 0), ("c", 2), ("after", None)]
    length = [end - start for _, _, start, end in spans]
    for _, parent, start, end in spans:
        if parent is not None:
            assert spans[parent][2] <= start <= end <= spans[parent][3]
    # reads: outer 0, a 10-20, b 30, c 40-50, b 60, outer 70, after 80-90
    assert length == [70, 10, 30, 10, 10]
    own = [length[i] - sum(length[j] for j, s in enumerate(spans) if s[1] == i)
           for i in range(len(spans))]
    assert own == [30, 10, 20, 10, 10]
    assert span("x") is span("y")  # off again after the block


def test_span_times_enclose_the_profiler_event_of_their_op():
    """Spans are on the clock of ``torch.profiler``'s event timestamps:
    the span around an ``aten`` op holds the op's CPU event."""
    x = torch.ones(64, 64)
    with record_spans() as spans:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            time.sleep(0.001)
            with span("matmul"):
                torch.matmul(x, x)
            time.sleep(0.001)
    ((name, _, start, end),) = spans
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::matmul"]
    assert name == "matmul" and len(events) == 1
    assert start <= events[0].start_ns() <= events[0].end_ns() <= end
    assert abs(start - time.time_ns()) < 60e9  # Unix-epoch nanoseconds


def test_record_spans_does_not_nest():
    with record_spans():
        with pytest.raises(RuntimeError, match="already recording"):
            with record_spans():
                pass
    with record_spans() as spans:
        with span("one"):
            pass
    assert [s[0] for s in spans] == ["one"]


def test_spans_inside_trace_are_record_function_ranges(tmp_path):
    with trace(str(tmp_path)) as prof:
        with span("phase.matmul"):
            torch.matmul(torch.ones(4, 4), torch.ones(4, 4))
    assert any(e.name == "phase.matmul" and e.is_user_annotation for e in prof.events())
    assert span("a") is span("b")  # off once the trace has ended
