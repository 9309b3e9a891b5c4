"""Tracing, NaN checks, structured metrics and step timing (port of
``cbfssm_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` trace of the block (host ops, and
  the card's kernels when CUDA is in use), written into a directory as
  a Chrome / TensorBoard trace file;
* :func:`debug_nans`: raise ``FloatingPointError`` at the first op,
  forward or backward, whose output holds a NaN;
* :class:`MetricsLogger`: append-only JSONL metrics (one object per
  event);
* :class:`StepTimer`: wall-clock steps/sec with warmup discard.
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
    taken; ``scripts/torch_trace_warmup.py`` compares the two forms."""
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
        yield prof
        if cuda:
            torch.cuda.synchronize()


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


class StepTimer:
    """Steps/sec over a sliding window, discarding warmup steps."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._count = 0
        # warmup=0 has no warmup tick to start the clock on, so the
        # window starts at construction
        self._t0 = time.perf_counter() if warmup == 0 else None
        self._timed_steps = 0

    def tick(self) -> None:
        # a tick marks the END of a step; the clock starts when the
        # warmup-th tick lands, and every later tick is a timed step
        self._count += 1
        if self._count == self.warmup:
            self._t0 = time.perf_counter()
        elif self._count > self.warmup:
            self._timed_steps += 1

    @property
    def steps_per_sec(self) -> float | None:
        if self._t0 is None or self._timed_steps == 0:
            return None
        return self._timed_steps / (time.perf_counter() - self._t0)
