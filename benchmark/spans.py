"""The program's spans laid over a run: host time, kernels and idle gaps
by the phase of training that spends them.

The port marks the Trainer's layers with spans
(``cbfssm_tpu_torch.utils.profiling.record_spans``): one ``(name,
parent, start_ns, end_ns)`` a span, in the order they began, ``parent``
the index of the enclosing span, the times on the clock of
``torch.profiler``'s event timestamps. ``phases`` maps a span's name to
its phase (the Trainer's ``SPAN_PHASES``). A span whose name has no
phase is cut out: its own time counts in no phase, its parent's
neither (the benchmark's own work inside the program's calls, such as
the feed's profiler start and stop); kernels launched and gaps begun
in it go under its name.

- :func:`host_ns_by_phase`: each phase's self time (a span's time less
  its children's) inside the given stretches of the host's clock;
- :func:`kernels_by_phase`: each device kernel of a trace, counted as
  ``benchmark.tracing.summarize`` counts ``kernels`` (no Memcpy or
  Memset, no user annotation), put down to the innermost span open when
  the runtime call that launched it began; the call is found by the
  profiler's correlation id, not by thread (autograd issues the backward
  from a thread of its own), and a kernel with no call in the trace,
  or a call outside every span, counts under :data:`OUTSIDE`;
- :func:`idle_by_span`: every idle gap of the traced span (the same
  gaps ``summarize`` finds) put down to the innermost span open when it
  began.

:func:`summarize` gives the summary keys the per-layer readers would
read; :func:`per_step` the nine per-step numbers.
"""

from __future__ import annotations

import bisect
import collections

import torch

from benchmark import tracing

OUTSIDE = "(no span)"
STEP = "step"  # one span a train step
HOST_PHASES = ("data", "forward", "backward", "optimizer", "eval", "bookkeeping")
KERNEL_PHASES = ("forward", "backward", "optimizer")
PARENTS = ("trainer.train", "trainer.epoch", STEP)  # spans with children


def self_intervals(spans) -> list:
    """Each span's own time as ``[(start, end), ...]``: its interval less
    its children's (the children of a span are disjoint, one thread)."""
    children = collections.defaultdict(list)
    for i, (_, parent, _, _) in enumerate(spans):
        if parent is not None:
            children[parent].append(i)
    out = []
    for i, (_, _, start, end) in enumerate(spans):
        own, cur = [], start
        for c in children[i]:
            c_start, c_end = spans[c][2], spans[c][3]
            if c_start > cur:
                own.append((cur, c_start))
            cur = max(cur, c_end)
        if end > cur:
            own.append((cur, end))
        out.append(own)
    return out


def _clipped(intervals, stretches) -> int:
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in intervals for lo, hi in stretches)


def host_ns_by_name(spans, stretches) -> dict:
    """{span name: self ns inside ``stretches``} (``[(lo, hi)]``, ns)."""
    out = collections.defaultdict(int)
    for (name, _, _, _), own in zip(spans, self_intervals(spans)):
        out[name] += _clipped(own, stretches)
    return dict(out)


def host_ns_by_phase(spans, phases, stretches) -> dict:
    """{phase: self ns inside ``stretches``}; cut-out spans count nowhere."""
    out = dict.fromkeys(sorted(set(phases.values())), 0)
    for name, ns in host_ns_by_name(spans, stretches).items():
        if name in phases:
            out[phases[name]] += ns
    return out


def count_in(spans, name, stretches) -> int:
    """The spans called ``name`` that begin inside ``stretches``."""
    return sum(n == name and any(lo <= s < hi for lo, hi in stretches)
               for n, _, s, _ in spans)


class Innermost:
    """The innermost span open at a time: the last span begun by then,
    or the first of its ancestors still open (spans nest, one thread)."""

    def __init__(self, spans, phases):
        self.spans, self.phases = spans, phases
        self.starts = [s[2] for s in spans]

    def index(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            if self.spans[i][3] >= t:
                return i
            i = self.spans[i][1]
        return None

    def name(self, t) -> str:
        i = self.index(t)
        return OUTSIDE if i is None else self.spans[i][0]

    def bucket(self, t) -> str:
        """The phase of the innermost span open at ``t`` (a cut-out
        span's own name; :data:`OUTSIDE` where none is open)."""
        name = self.name(t)
        return self.phases.get(name, name)


def is_kernel(e) -> bool:
    """A device event that ``tracing.summarize`` counts in ``kernels``."""
    return (e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
            and not e.name().startswith(("Memcpy", "Memset")))


def kernels_by_phase(events, spans, phases) -> dict:
    """{phase (or cut-out span, or OUTSIDE): kernels} over ``events``
    (the profiler's ``_KinetoEvent`` list)."""
    cuda = torch.autograd.DeviceType.CUDA
    launched = {}  # correlation id -> start of the runtime or driver call
    for e in events:
        if e.device_type() != cuda and e.name().startswith("cu"):
            launched[e.correlation_id()] = e.start_ns()
    where = Innermost(spans, phases)
    out = collections.Counter()
    for e in events:
        if is_kernel(e):
            t = launched.get(e.correlation_id())
            out[OUTSIDE if t is None else where.bucket(t)] += 1
    return dict(out)


def idle_gaps(events):
    """The traced span's idle gaps ``[(start, length)]`` in ns, as
    ``tracing.summarize`` finds them."""
    cuda = torch.autograd.DeviceType.CUDA
    device, everything = [], []
    for e in events:
        if e.name().startswith("ProfilerStep#"):
            continue
        if e.device_type() != cuda:
            everything.append((e.start_ns(), e.end_ns()))
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns()))
            everything.append(device[-1])
    if not device:
        return []
    lo, hi = min(s for s, _ in everything), max(e for _, e in everything)
    return tracing._union(sorted(device), lo, hi)[1]


def idle_by_span(events, spans, phases) -> dict:
    """{span name (or OUTSIDE): [gaps, seconds]} over every idle gap."""
    where = Innermost(spans, phases)
    out = collections.defaultdict(lambda: [0, 0.0])
    for start, length in idle_gaps(events):
        name = where.name(start)
        out[name][0] += 1
        out[name][1] += length / 1e9
    return dict(out)


def summarize(spans, phases, untraced, events=None) -> dict:
    """The summary keys of the spans: host self ns by phase and the
    ``step`` spans inside the ``untraced`` stretches, and with the traced
    span's ``events`` the kernels by phase and every idle gap by span.
    Keys of their own, so the existing summary's keys stay as they were."""
    out = {"span_host_ns": host_ns_by_phase(spans, phases, untraced),
           "span_host_ns_by_name": host_ns_by_name(spans, untraced),
           "span_steps": count_in(spans, STEP, untraced)}
    if events is not None:
        out["span_kernels"] = kernels_by_phase(events, spans, phases)
        out["span_idle"] = idle_by_span(events, spans, phases)
    return out


def per_step(summary) -> dict:
    """The per-step numbers of :func:`summarize`'s keys: each phase's host
    ms a step over the untraced stretch, and the forward, backward and
    optimizer kernels a traced train step (``train_steps``). Missing
    keys (a program without spans) give nothing."""
    out = {}
    steps = summary.get("span_steps")
    if steps:
        for phase in HOST_PHASES:
            out[f"{phase}_host_ms_per_step.train"] = (
                summary["span_host_ns"].get(phase, 0) / 1e6 / steps)
    kernels, traced = summary.get("span_kernels"), summary.get("train_steps")
    if kernels is not None and traced:
        for phase in KERNEL_PHASES:
            out[f"{phase}_kernels_per_step.train"] = kernels.get(phase, 0) / traced
    return out


def idle_spans(summary, phases, top: int = 10) -> list:
    """``[[phase, seconds], ...]``: :func:`summarize`'s idle gaps folded
    into phases (the breakdown's third list)."""
    by_phase = collections.defaultdict(float)
    for name, (_, seconds) in summary.get("span_idle", {}).items():
        by_phase[phases.get(name, name)] += seconds
    return [[k, v] for k, v in sorted(by_phase.items(), key=lambda kv: -kv[1])[:top]]
