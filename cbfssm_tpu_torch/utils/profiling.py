"""Tracing, spans, NaN checks and structured metrics (port of
``cbfssm_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` trace of the block (host ops, and
  the card's kernels when CUDA is in use), written into a directory as
  a Chrome / TensorBoard trace file;
* :func:`span` / :func:`record_spans`: named host-time spans of the
  program's layers (the Trainer's phases), recorded in memory while a
  caller asks for them;
* :func:`debug_nans`: raise ``FloatingPointError`` at the first op,
  forward or backward, whose output holds a NaN;
* :class:`MetricsLogger`: append-only JSONL metrics (one object per
  event).

Spans are off by default: :func:`span` then hands back one shared
object that does nothing (no allocation, no torch call, no clock read).
Inside :func:`record_spans` each span is kept as ``(name, parent,
start_ns, end_ns)``: ``parent`` is the index in the list of the span
that was open when it began (``None`` at the top). The times are
``time.perf_counter_ns`` readings plus one offset to ``time.time_ns``,
read when recording starts: Unix-epoch nanoseconds, the clock of
``torch.profiler``'s event timestamps (``_KinetoEvent.start_ns()``), on
the CPU and on the card. So a span can be laid over a profiler trace of
the same stretch: the runtime call that launched a kernel, or an idle
gap of the device, falls inside the spans that were open then. Inside
:func:`trace` spans also open ``torch.profiler.record_function`` ranges,
so the written trace shows them. Spans are opened and closed on one
thread (the Trainer's); the switch is process-wide, as
``debug_nans``'s is.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


# the discarded first cycle of :func:`trace` on the card
_WARM_UP_KERNELS = 64
_WARM_UP_S = 0.05
_SETTLE_S = 0.05


def recording() -> bool:
    """Whether a ``torch.profiler`` trace is recording in this process."""
    return torch._C._autograd._profiler_enabled()


def settle():
    """Wait until a recording profiler can have received the records of
    the card's work issued so far: a device sync, then ``_SETTLE_S``.
    The profiler receives a CUDA graph's kernel records some milliseconds
    after the kernels ran: on an H100 host a trace stopped right after
    the sync lost records of a replayed epoch's last kernels (122 of its
    7,581 GP-predict kernels in one RoboMove trace)."""
    torch.cuda.synchronize()
    time.sleep(_SETTLE_S)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write its trace into
    ``log_dir`` (``<host>_<pid>.<time>.pt.trace.json``, which Chrome's
    trace viewer and TensorBoard's profiler plugin read): host ops, and
    the card's kernels when CUDA is in use in this process. Yields the
    ``torch.profiler.profile`` object, whose ``events()`` hold the trace
    once the block has ended.

    The block is the second cycle of a schedule whose first cycle, the
    warm-up, is discarded; with CUDA the warm-up launches
    ``_WARM_UP_KERNELS`` small kernels, waits for them and sleeps
    ``_WARM_UP_S``. On an H100 host a trace without it lost the first
    kernel events of the block, more with every trace the process had
    taken; ``scripts/torch_trace_warmup.py`` compares the two forms.
    Inside the block each :func:`span` is also a ``record_function``
    range of its name, so the trace shows the program's phases. The
    block ends with :func:`settle`."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        if cuda:
            x = torch.zeros((), device=torch.cuda.current_device())
            for _ in range(_WARM_UP_KERNELS):
                x.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(_WARM_UP_S)
        prof.step()  # the warm-up ends and the recorded cycle starts
        _SPANS.annotate += 1
        _SPANS.refresh()
        try:
            yield prof
            if cuda:
                settle()
        finally:
            _SPANS.annotate -= 1
            _SPANS.refresh()


class _Spans:
    """The process's span switch: the list being recorded (``None``:
    not recording), the index of the innermost open span in it, and how
    many :func:`trace` blocks are open; ``on`` while either asks for
    spans."""

    def __init__(self):
        self.records = None
        self.open = None
        self.annotate = 0
        self.on = False

    def refresh(self):
        self.on = self.records is not None or self.annotate > 0


_SPANS = _Spans()


class _NoSpan:
    """What :func:`span` returns while spans are off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "records", "index", "parent", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _SPANS.annotate:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.records = _SPANS.records
        if self.records is not None:
            self.parent, self.index = _SPANS.open, len(self.records)
            _SPANS.open = self.index
            self.records.append([self.name, self.parent, time.perf_counter_ns(), None])
        return self

    def __exit__(self, *exc):
        if self.records is not None:
            self.records[self.index][3] = time.perf_counter_ns()
            if _SPANS.records is self.records:
                _SPANS.open = self.parent
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that marks its block as the span ``name`` while
    :func:`record_spans` or :func:`trace` is on, and does nothing (one
    shared object) otherwise. A span launches no kernel and reads
    nothing back from the device."""
    if not _SPANS.on:
        return _NO_SPAN
    return _Span(name)


@contextlib.contextmanager
def record_spans():
    """Record every span opened inside the block. Yields a list that,
    once the block has ended, holds one ``(name, parent, start_ns,
    end_ns)`` a span in the order the spans began (the module docstring
    gives the clock); a span still open then ends there. Nothing is
    written anywhere else."""
    if _SPANS.records is not None:
        raise RuntimeError("record_spans() is already recording")
    out = []
    offset = time.time_ns() - time.perf_counter_ns()
    _SPANS.records, _SPANS.open = [], None
    _SPANS.refresh()
    try:
        yield out
    finally:
        end = time.perf_counter_ns()
        records = _SPANS.records
        _SPANS.records, _SPANS.open = None, None
        _SPANS.refresh()
        out.extend((name, parent, start + offset, (end if stop is None else stop) + offset)
                   for name, parent, start, stop in records)


# ops whose outputs are uninitialised memory, which may hold NaN bits
_UNINITIALISED = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}
# process-wide, as JAX's jax_debug_nans flag and autograd's anomaly mode
# are: the autograd engine runs a CUDA backward on its own threads
_NAN_CHECK = {"on": False}


class _NanCheck(TorchDispatchMode):
    """Checks every floating output of every op while ``_NAN_CHECK`` is on."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _NAN_CHECK["on"] and func not in _UNINITIALISED:
            for t in pytree.tree_leaves(out):
                if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"debug_nans: {func} produced NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise ``FloatingPointError`` at the first op inside the block whose
    output holds a NaN, forward or backward (autograd's anomaly mode is
    on too, so the error names the forward op of a failing backward).
    ``enable=False`` turns the check off inside an enclosing block. Both
    switches return to their previous state on exit. Every op then
    waits for its result: a debugging tool, not for timed runs."""
    prev, prev_anomaly = _NAN_CHECK["on"], torch.is_anomaly_enabled()
    _NAN_CHECK["on"] = enable
    torch.autograd.set_detect_anomaly(enable)
    try:
        with _NanCheck() if enable else contextlib.nullcontext():
            yield
    finally:
        _NAN_CHECK["on"] = prev
        torch.autograd.set_detect_anomaly(prev_anomaly)


class MetricsLogger:
    """Append-only JSONL event stream (one JSON object per line)."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            # truncate: one file per run
            open(path, "w").close()

    def log(self, **event) -> None:
        if not self.path:
            return
        event.setdefault("time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")
