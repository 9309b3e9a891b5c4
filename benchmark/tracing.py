"""The traced span of a run and its summary.

:class:`Trace` records a span under ``torch.profiler``: the card's
activity and the CUDA runtime calls that issue it (on a host without a
card, host ops). As the port's ``utils/profiling.trace`` learned
on the H100 (a trace without it lost the first kernel events of the
block), the recorded cycle follows a discarded warm-up cycle of 64
small kernels, a sync and 50 ms. The span starts and ends at a device
sync, so every device operation it holds was issued inside it.

:func:`summarize` reduces the profiler's events to what the per-layer
readers in ``benchmark/metrics/`` read: the span's length, the union of
device-operation intervals (busy time), the device operations by name
(count, seconds), and the idle gaps attributed to the innermost host
event (a runtime call) running when each began, "(no host op)" where
the host was between calls (in Python and PyTorch's dispatch).
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

GAP_SAMPLE = 2000  # the longest idle gaps attributed to a host op
SCAN = 400  # host ops scanned back for the one enclosing a gap


class Trace:
    def __init__(self):
        self._prof = None
        self._t0 = None
        self.summary = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        # the card's activity alone (kernels, copies and the CUDA runtime
        # calls that issue them): recording every host op as well made a
        # RoboMove step ~2.8x slower on the H100's host
        activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        if cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1))
        self._prof.__enter__()
        if cuda:
            x = torch.zeros((), device=torch.cuda.current_device())
            for _ in range(64):
                x.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.05)
        self._prof.step()  # the warm-up cycle ends, the recorded one starts
        self._t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        host_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        self.summary = summarize(events, host_s)
        return self.summary


def _union(intervals, lo, hi):
    """(busy ns, gaps [(start, length)]) of sorted ``intervals`` clipped to [lo, hi]."""
    busy, gaps, cur = 0, [], lo
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s - cur))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi - cur))
    return busy, gaps


def summarize(events, host_s: float) -> dict:
    """The span (``window_s``: the host's clock between its two syncs)
    and its events: device operations, and host events (runtime calls,
    or host ops on a host without a card) for the idle gaps."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        if e.name().startswith("ProfilerStep#"):  # the schedule's cycle marker
            continue
        if e.device_type() != cuda:
            host.append((e.start_ns(), e.end_ns(), e.name()))
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name()))
    device.sort()
    by_name = collections.defaultdict(lambda: [0, 0.0])
    kernels = 0
    for s, e, name in device:
        by_name[name][0] += 1
        by_name[name][1] += (e - s) / 1e9
        kernels += not name.startswith(("Memcpy", "Memset"))
    busy_ns, gaps = 0, []
    if device:
        everything = host + device
        lo, hi = min(s for s, _, _ in everything), max(e for _, e, _ in everything)
        busy_ns, gaps = _union([(s, e) for s, e, _ in device], lo, hi)
    return {
        "window_s": host_s,
        "busy_s": busy_ns / 1e9,
        "device_ops": len(device),
        "kernels": kernels,
        "device_ops_by_name": {k: [c, t] for k, (c, t) in by_name.items()},
        "idle_by_host_op": _attribute(gaps, host),
    }


def _attribute(gaps, host) -> dict:
    """{host op: [gaps, seconds]} over the :data:`GAP_SAMPLE` longest idle
    gaps: the innermost host op (latest start) running when each began."""
    host.sort()
    starts = [s for s, _, _ in host]
    out = collections.defaultdict(lambda: [0, 0.0])
    for g_start, g_len in sorted(gaps, key=lambda g: -g[1])[:GAP_SAMPLE]:
        name = "(no host op)"
        i = bisect.bisect_right(starts, g_start) - 1
        for j in range(i, max(-1, i - SCAN), -1):
            s, e, n = host[j]
            if e >= g_start:
                name = n
                break
        out[name][0] += 1
        out[name][1] += g_len / 1e9
    return dict(out)


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device ops that took most time and the host ops behind the
    longest idle gaps, ``[[name, seconds], ...]`` each."""
    ops = sorted(summary["device_ops_by_name"].items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(summary["idle_by_host_op"].items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[n, v[1]] for n, v in ops], "idle_gaps": [[n, v[1]] for n, v in idle]}
