"""The Trainer's CUDA graphs on a benchmark cell's model, on the card:
the graphed Trainer against the same Trainer made ineligible (eager).

    python3 scripts/torch_step_graph.py --workload robomove-train --epochs 2 \\
        --seed 9200000001 --out build/step_graph_robomove.json

Builds the cell's data, model and weights as the benchmark does
(``benchmark.mixes.train.Run``), then trains ``--epochs`` epochs of the
whole dataset twice from the same weights and seed, eager first: each
run's per-epoch seconds, device memory over the run's start (its peak,
its end, after each of the first steps), ``graph_counts()`` and GP
kernel launches (``step_graph.launches``); whether the per-epoch losses, the leaves and Adam's state are
bitwise equal; and, in a CUDA-only profiler trace of the benchmark's
kind (``benchmark.tracing.Trace``) started after the capture,
``--trace-steps`` further train steps of each run: the kernels and
device time a step. Prints one JSON line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmark import run as _bench_run  # noqa: E402,F401  (the benchmark's caches and threads)

import torch  # noqa: E402

from benchmark import harness, tracing  # noqa: E402
from benchmark.mixes.train import Run  # noqa: E402
from cbfssm_tpu_torch.training import Trainer, step_graph  # noqa: E402
from cbfssm_tpu_torch.utils import profiling  # noqa: E402

# ``--device cpu --tiny``: a rehearsal at the benchmark tests' sizes
TINY = {
    "robomove-train": {"model": {"batch_size": 4, "samples": 2, "ind_pnt_num": 5,
                                 "recog_len": 5},
                       "data": {"seq_len": 30, "seq_stride": 500}},
    "voliro-train": {"model": {"batch_size": 8, "samples": 2, "ind_pnt_num": 5,
                               "epochs_per_dispatch": 2}},
}


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def train(run, graphed: bool, epochs: int, trace_steps: int) -> dict:
    m = run.cfg["model"]
    structure = run.model.init(torch.Generator(device=run.device).manual_seed(0))
    path = os.path.join(run.tmp, "graph" if graphed else "eager")
    metrics = os.path.join(path, "metrics.jsonl")
    tr = Trainer(run.model, path, seed=run.seed, init_params=structure.with_tensors(run.leaves),
                 metrics_path=metrics, epochs_per_dispatch=int(m["epochs_per_dispatch"]))
    tr._graph_on = graphed and tr._graph_on
    sync(run.device)
    cuda = run.device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated() if cuda else 0
    memory, step = [], tr.train_step

    def noted_step(*args):  # device memory after each of the first steps
        out = step(*args)
        if cuda and len(memory) < 4:
            memory.append([torch.cuda.memory_allocated() - start_bytes,
                           torch.cuda.max_memory_allocated() - start_bytes])
        return out

    tr.train_step = noted_step
    before = step_graph.launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        tr.train(run.ds, epochs)
    sync(run.device)
    seconds = time.perf_counter() - t0
    del tr.train_step
    launches = {k: n - before[k] for k, n in step_graph.launches().items()}
    with open(metrics) as f:
        events = [json.loads(line) for line in f]
    out = {
        "graphed": graphed, "seconds": seconds,
        "epoch_seconds": [e["seconds"] for e in events if e["event"] == "epoch"],
        "peak_bytes": torch.cuda.max_memory_allocated() - start_bytes if cuda else 0,
        "end_bytes": torch.cuda.memory_allocated() - start_bytes if cuda else 0,
        "first_steps_bytes": memory, "launches": launches,
        "counts": tr.graph_counts(), "train_all": tr.train_all, "test_all": tr.test_all,
        "done": [e for e in events if e["event"] == "done"],
    }
    state = ([t.detach().cpu() for t in tr.params.tensors()],
             {i: {k: t.cpu() for k, t in st.items()}
              for i, st in tr.optimizer.state_dict()["state"].items()})
    # a trace of the benchmark's kind, started after the capture
    batch = int(m["batch_size"])
    data_u, data_y = tr._stage("train", run.ds.train_in_batch, run.ds.train_out_batch)
    batches = tr._batches(data_u, data_y, batch, True, epochs, 0)
    trace = tracing.Trace()
    trace.start()
    for _ in range(trace_steps):
        tr.train_step(*next(batches))
    if cuda:
        profiling.settle()
    summary = trace.stop()
    out["trace"] = {"steps": trace_steps, "kernels_per_step": summary["kernels"] / trace_steps,
                    "device_ms_per_step": 1e3 * summary["busy_s"] / trace_steps,
                    "window_ms_per_step": 1e3 * summary["window_s"] / trace_steps}
    out["counts_after_trace"] = tr.graph_counts()
    return out, state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=9200000001)
    parser.add_argument("--trace-steps", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    cell = harness.Cell(args.workload, overrides=TINY[args.workload] if args.tiny else None)
    run = Run(cell, args.seed, args.device)
    try:
        run.make_inputs()
        run.build()
        results, states = {}, {}
        for graphed in (False, True):
            results[graphed], states[graphed] = train(run, graphed, args.epochs, args.trace_steps)
    finally:
        run.close()
    (leaves_e, opt_e), (leaves_g, opt_g) = states[False], states[True]
    equal = {
        "losses": (results[True]["train_all"] == results[False]["train_all"]
                   and results[True]["test_all"] == results[False]["test_all"]),
        "leaves": all(torch.equal(a, b) for a, b in zip(leaves_g, leaves_e)),
        "adam": opt_g.keys() == opt_e.keys() and all(
            torch.equal(opt_g[i][k], opt_e[i][k]) for i in opt_e for k in opt_e[i]),
    }
    out = {"workload": args.workload, "seed": args.seed, "epochs": args.epochs,
           "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
           "torch": torch.__version__,
           "equal": equal, "eager": results[False], "graph": results[True]}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
