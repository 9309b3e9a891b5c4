"""The Trainer's spans in a benchmark cell: the recorder's cost, and a
training step's host time and kernels by phase, on the card.

    python3 scripts/torch_trainer_spans.py --workload voliro-train --pairs 3 \\
        --seconds 51 --seed 9000000001 --out build/spans_voliro.json

Runs the cell through ``benchmark.harness.execute`` in this process:

1. ``--pairs`` pairs of untraced runs, spans off and on in turns (off
   first in even pairs), the two runs of a pair on one seed: each run's
   ``train_steps_per_s``, and for a run with spans each phase's host ms a
   step over the window (the second ``trainer.train`` span) against the
   window's time a step;
2. one traced run with spans on (``--trace-seed``): the benchmark's
   profiler start and stop are wrapped in spans that no phase owns, so
   they are cut out; the host ms by phase over the run's untraced epochs
   (the stretch that gives ``step_s``), the kernels by phase in the
   traced epochs (every attributed kernel's launch call inside its
   span, the phases and the rest summing to ``kernels``) and every idle
   gap put down to a span;
3. the clock: a span around a few kernel launches under a CUDA-only
   ``torch.profiler`` trace (the benchmark's kind), whose launch calls
   must lie inside the span. It comes last: a trace taken earlier in the
   process lost kernel events of the traced run (ROADMAP.md, C11).

Prints one JSON line with all of it and writes it to ``--out``.
``--device cpu --tiny`` rehearses it on the CPU at the benchmark tests'
tiny sizes (host times only: a CPU trace holds no kernels).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmark import run as _bench_run  # noqa: E402,F401  (the benchmark's caches and threads)

import torch  # noqa: E402

from benchmark import harness, spans, tracing  # noqa: E402
from cbfssm_tpu_torch.training.trainer import SPAN_PHASES  # noqa: E402
from cbfssm_tpu_torch.utils.profiling import record_spans, span  # noqa: E402

TINY = {
    "robomove-train": {"model": {"batch_size": 4, "samples": 2, "ind_pnt_num": 5,
                                 "recog_len": 5},
                       "data": {"seq_len": 30, "seq_stride": 500},
                       "traffic": {"trace_steps": 4}},
    "voliro-train": {"model": {"batch_size": 8, "samples": 2, "ind_pnt_num": 5,
                               "epochs_per_dispatch": 2},
                     "traffic": {"trace_steps": 2}},
}
TRACE_START, TRACE_STOP = "benchmark.trace_start", "benchmark.trace_stop"


def clock_check(device: str) -> dict:
    """Spans around launches under a CUDA-only trace: every launch call
    (runtime or driver API) lies inside its span, and each kernel's
    correlation id finds its call."""
    if device != "cuda":
        return {"device": device}
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(4096, device="cuda")
    torch.cuda.synchronize()
    with record_spans() as recorded:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for k in range(4):
                with span(f"probe{k}"):
                    x.add_(1.0)
                    x.mul_(0.5)
                time.sleep(0.001)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    calls = {e.correlation_id(): e for e in events
             if e.device_type() != cuda and e.name().startswith("cu")}
    kernels = [e for e in events if spans.is_kernel(e)]
    inside = 0
    for e in kernels:
        call = calls.get(e.correlation_id())
        if call is not None and any(s <= call.start_ns() and call.end_ns() <= t
                                    for _, _, s, t in recorded):
            inside += 1
    return {"kernels": len(kernels), "launch_calls_inside_their_span": inside,
            "spans": len(recorded), "torch": torch.__version__, "cuda": torch.version.cuda,
            "card": torch.cuda.get_device_name(0)}


def window_span(recorded):
    """The window's ``trainer.train`` span (set-up's is the first)."""
    top = [s for s in recorded if s[0] == "trainer.train" and s[1] is None]
    if len(top) != 2:
        raise RuntimeError(f"{len(top)} top-level trainer.train spans, want set-up's and the "
                           f"window's")
    return top[1]


def host_report(recorded, stretches, step_ms: float) -> dict:
    """Each phase's host ms a step over ``stretches``, their sum against
    ``step_ms`` and the parents' share of it."""
    summary = spans.summarize(recorded, SPAN_PHASES, stretches)
    per = spans.per_step(summary)
    host = {k: v for k, v in per.items() if "_host_ms_" in k}
    total = sum(host.values())
    by_name = summary["span_host_ns_by_name"]
    parents = sum(by_name.get(n, 0) for n in spans.PARENTS) / 1e6 / summary["span_steps"]
    cut = sum(v for n, v in by_name.items() if n not in SPAN_PHASES) / 1e9
    return {"steps": summary["span_steps"], "host_ms_per_step": host, "sum_ms": total,
            "step_ms": step_ms, "sum_over_step": total / step_ms if step_ms else None,
            "parents_self_share": parents / total if total else None, "cut_out_s": cut,
            "self_ms_per_step_by_span": {n: v / 1e6 / summary["span_steps"]
                                         for n, v in sorted(by_name.items())}}


def untraced_pair(workload, seed, seconds, device, overrides, spans_on: bool) -> dict:
    with record_spans() if spans_on else contextlib.nullcontext() as recorded:
        out = harness.execute(workload, seed, seconds, False, device=device, overrides=overrides)
    rate = out["metrics"]["train_steps_per_s"]["value"]
    res = {"seed": seed, "spans": spans_on, "train_steps_per_s": rate,
           "correct": out["correct"]}
    if spans_on:
        w = window_span(recorded)
        res["spans_recorded"] = len(recorded)
        res["host"] = host_report(recorded, [(w[2], w[3])], 1e3 / rate)
    return res


def traced_run(workload, seed, seconds, device, overrides) -> dict:
    """One ``--trace 1`` run with spans on; the trace's events and
    summary kept for the spans' attribution."""
    kept = {}
    start, stop, summarize = tracing.Trace.start, tracing.Trace.stop, tracing.summarize

    def start_spanned(self):
        with span(TRACE_START):
            return start(self)

    def stop_spanned(self):
        with span(TRACE_STOP):
            kept["summary"] = stop(self)
            return kept["summary"]

    def summarize_kept(events, host_s):
        kept["events"] = events
        return summarize(events, host_s)

    tracing.Trace.start, tracing.Trace.stop = start_spanned, stop_spanned
    tracing.summarize = summarize_kept
    try:
        with record_spans() as recorded:
            out = harness.execute(workload, seed, seconds, True, device=device,
                                  overrides=overrides)
    finally:
        tracing.Trace.start, tracing.Trace.stop, tracing.summarize = start, stop, summarize
    summary, events = kept["summary"], kept["events"]
    w = window_span(recorded)
    (t_start,) = [s for s in recorded if s[0] == TRACE_START]
    (t_stop,) = [s for s in recorded if s[0] == TRACE_STOP]
    untraced = [(w[2], t_start[2]), (t_stop[3], w[3])]
    traced = [(t_start[3], t_stop[2])]
    extra = spans.summarize(recorded, SPAN_PHASES, untraced, events)
    merged = dict(summary, **extra)
    per = spans.per_step(merged)
    # every kernel put down to a span was launched inside it
    where = spans.Innermost(recorded, SPAN_PHASES)
    cuda = torch.autograd.DeviceType.CUDA
    calls = {e.correlation_id(): (e.start_ns(), e.end_ns()) for e in events
             if e.device_type() != cuda and e.name().startswith("cu")}
    in_span = outside_span = 0
    for e in events:
        if spans.is_kernel(e):
            call = calls.get(e.correlation_id())
            i = None if call is None else where.index(call[0])
            if i is None:
                continue
            s = recorded[i]
            if s[2] <= call[0] <= s[3]:
                in_span += 1
            else:
                outside_span += 1
    idle_s = summary["window_s"] - summary["busy_s"]
    idle_total = sum(v[1] for v in extra["span_idle"].values())
    idle_parents = sum(v[1] for n, v in extra["span_idle"].items() if n in spans.PARENTS)
    return {
        "seed": seed, "correct": out["correct"], "metrics": out["metrics"],
        "device": out["device"], "breakdown": dict(
            out["breakdown"], idle_spans=spans.idle_spans(extra, SPAN_PHASES)),
        "per_step": per,
        "host": host_report(recorded, untraced, 1e3 * summary["step_s"]),
        "traced_steps_in_spans": spans.count_in(recorded, spans.STEP, traced),
        "train_steps": summary["train_steps"], "eval_batches": summary["eval_batches"],
        "eval_spans_traced": spans.count_in(recorded, "eval.loss", traced),
        "kernels": summary["kernels"], "kernels_by_phase": extra["span_kernels"],
        "kernels_sum": sum(extra["span_kernels"].values()),
        "kernels_launched_inside_their_span": in_span,
        "kernels_launched_outside_their_span": outside_span,
        "idle_s": idle_s, "idle_spans_s": idle_total,
        "idle_spans_over_idle": idle_total / idle_s if idle_s else None,
        "idle_under_parents_share": idle_parents / idle_total if idle_total else None,
        "idle_by_span": {n: v for n, v in sorted(extra["span_idle"].items(),
                                                 key=lambda kv: -kv[1][1])},
        "step_s": summary["step_s"], "window_s": summary["window_s"],
        "busy_s": summary["busy_s"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--seed", type=int, default=9000000001)
    parser.add_argument("--trace-seed", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    overrides = TINY[args.workload] if args.tiny else None
    result = {"workload": args.workload, "card": harness.power_limit(), "pairs": []}
    for k in range(args.pairs):
        seed = args.seed + k
        for spans_on in ((False, True) if k % 2 == 0 else (True, False)):
            res = untraced_pair(args.workload, seed, args.seconds, args.device, overrides,
                                spans_on)
            result["pairs"].append(res)
            print(json.dumps(res), file=sys.stderr, flush=True)
    trace_seed = args.trace_seed if args.trace_seed is not None else args.seed + args.pairs
    result["traced"] = traced_run(args.workload, trace_seed, args.seconds, args.device,
                                  overrides)
    result["clock"] = clock_check(args.device)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
