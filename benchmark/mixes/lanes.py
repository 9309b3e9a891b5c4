"""The lane mix (a traffic file with ``"mix": "lanes"``): one run of a
cell that trains a reproduction's seeds as the lanes of one program,
from set-up to the numbers compared.

The training mix (:mod:`benchmark.mixes.train`, whose ``Run``, ``Feed``
and ``compare`` this module extends) with the port's lane program,
``cbfssm_tpu_torch.training.MultiSeedTrainer``, in the ``Trainer``'s
place: the configuration's ``reproduction.iterations`` lanes, each
with its own weights made here (stacked, through ``init_params``), its
own shuffle of the training windows and its own draws. The feed
(``noise_fn``) hands every lane the first ``check_steps`` steps' draws
but the last's; the last checked step draws its own by the lane rule
(:mod:`benchmark.reference.lanes`), as every step of the window does. A
step is one lane-batched Adam step, which advances every lane.

The configuration may cut an epoch's windows (``data.train_windows``,
``data.test_windows``): the first windows of each split, cut after the
program's data layer has built and z-scored them all.

The phases are the training mix's: set-up (``MultiSeedTrainer.train``
on the set-up's windows until the checked steps are done, a test batch,
checkpoints), the window (a second ``train(retrain=True)``, ended by the
feed at the first epoch boundary at or after ``--seconds``, closed by a
device sync), the check. With ``--trace 1`` whole epochs from the
second are traced, timed apart from the untraced ones, and the window
is also recorded under the program's ``record_spans()``: the summary
adds :func:`benchmark.spans.summarize` over the untraced stretches, and
the lane GP kernel launches the program counted over the traced span
(``lane_launches``). On a program without spans the span keys hold no
step and their readers give nothing.

The check follows each lane's first steps from its weights, rows and
draws in float64 after the window, one lane at a time, and takes the
worst lane of each number :func:`benchmark.mixes.train.compare` gives
(:func:`compare`).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import harness, spans, tracing
from benchmark.mixes import train
from benchmark.mixes.train import StopWindow, sync
from benchmark.reference import common, lanes


def _program_profiling():
    """The program's ``span``, ``record_spans`` and span phases."""
    from cbfssm_tpu_torch.training.trainer import SPAN_PHASES
    from cbfssm_tpu_torch.utils.profiling import record_spans, span

    return span, record_spans, SPAN_PHASES


def _lane_launches() -> int:
    """The lane GP kernel launches the program has issued so far."""
    from cbfssm_tpu_torch.ops import fused_predict as fp

    return fp.fused_predict_residuals.lane_launches + fp.fused_predict.lane_launches


def cut(cfg, windows: dict) -> dict:
    """The first ``data.train_windows`` / ``data.test_windows`` windows
    of each split (all where the configuration names no cut)."""
    d = cfg["data"]
    keep = {"train": d.get("train_windows"), "test": d.get("test_windows")}
    return {split: tuple(a[:keep[split]] for a in arrays) for split, arrays in windows.items()}


class Trace(tracing.Trace):
    """:class:`benchmark.tracing.Trace` that keeps the profiler's events
    (``events``), counts the program's lane GP launches over the span
    (``summary['lane_launches']``), and marks its start and stop as the
    benchmark's own spans (they have no phase: cut out of the
    program's)."""

    def __init__(self):
        super().__init__()
        self.events = None
        self._launches = 0

    def start(self):
        span = _program_profiling()[0]
        with span("benchmark.trace_start"):
            super().start()
            self._launches = _lane_launches()

    def stop(self):
        span = _program_profiling()[0]
        with span("benchmark.trace_stop"):
            launches = _lane_launches() - self._launches
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            host_s = time.perf_counter() - self._t0
            self._prof.__exit__(None, None, None)
            self.events = self._prof.profiler.kineto_results.events()
            self._prof = None
            self.summary = tracing.summarize(self.events, host_s)
            self.summary["lane_launches"] = launches
        return self.summary


class Feed(train.Feed):
    """The lane program's ``noise_fn(epoch, split, i, lane, b, t_len)``:
    each lane's draws for the checked steps, and, at lane 0's call, the
    training feed's marks of epochs and counts of batches."""

    def __init__(self, run):
        super().__init__(run)
        self.trace = Trace()

    def __call__(self, epoch, split, i, lane, b, t_len):
        if self.phase == "setup":
            if split == 0:
                if lane == 0:
                    self.train_calls += 1
                k = self.train_calls - 1
                if k < len(self.run.check_noise):
                    return self.run.noise_cls(*self.run.check_noise[k][lane])
                if k == len(self.run.check_noise) and (epoch, i) != self.run.drawn_at:
                    raise RuntimeError(f"the last checked step is batch {i} of epoch {epoch}, "
                                       f"the reference reckons {self.run.drawn_at}")
            return None
        if lane == 0:
            if split == 0 and i == 0:
                self._epoch_start(epoch)
            self.counts[split] += 1
        return None


class Run(train.Run):
    """One run's state: inputs for every lane, the lane program, readings
    (each a list over the lanes)."""

    def __init__(self, cell, seed: int, device: str = "cuda"):
        super().__init__(cell, seed, device)
        self.n_lanes = int(self.cfg["reproduction"]["iterations"])
        gp = self.cfg.get("gp_predict")
        if gp is not None and int(gp["l"]) != self.n_lanes:
            raise ValueError(f"gp_predict reckons {gp['l']} lanes, the reproduction "
                             f"trains {self.n_lanes}")

    # --- inputs ------------------------------------------------------------

    def make_inputs(self):
        """As the training mix's, for every lane: ``leaves`` and each
        checked step's draws (``check_noise[step][lane]``) a lane."""
        self.raw = self.ref.make_raw(self.cfg, self.seed)
        self.data_dir = os.path.join(self.tmp, "data")
        os.makedirs(self.data_dir)
        self.ref.write_raw(self.cfg, self.raw, self.data_dir)
        self.windows = cut(self.cfg, self.ref.windows(self.cfg, self.raw))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.leaves = [self.ref.init(self.cfg, gen, self.dtype, self.device)
                       for _ in range(self.n_lanes)]
        n_train, self.t_len = self.windows["train"][0].shape[:2]
        batch = int(self.cfg["model"]["batch_size"])
        self.n_check = int(self.cell.traffic["check_steps"])
        rows = np.random.default_rng([self.seed, 1]).choice(
            n_train, min(n_train, self.n_check * batch), replace=False)
        self.warm_rows = np.sort(rows)
        self.shapes = self.ref.noise_shapes(self.cfg, batch, self.t_len)
        self.check_noise = [[common.draws(self.shapes, gen, self.dtype, self.device)
                             for _ in range(self.n_lanes)] for _ in range(self.n_check - 1)]
        per_epoch = -(-len(self.warm_rows) // batch)
        self.drawn_at = divmod(self.n_check - 1, per_epoch)

    # --- the program ------------------------------------------------------------

    def build(self):
        prog = self.cfg["program"]
        package = harness.import_attr(prog["model"]).__module__.split(".")[0]
        where = Path(sys.modules[package].__file__).resolve()
        if not where.is_relative_to(harness.ROOT):
            raise RuntimeError(f"{package} comes from {where}, outside the checkout "
                               f"{harness.ROOT}: the benchmark measures the checkout's")
        m, d = self.cfg["model"], self.cfg["data"]
        with contextlib.redirect_stdout(sys.stderr):
            self.ds = harness.import_attr(prog["dataset"])(
                int(d["seq_len"]), int(d["seq_stride"]), data_dir=self.data_dir)
        for split, arrays in cut(self.cfg, {
                "train": (self.ds.train_in_batch, self.ds.train_out_batch),
                "test": (self.ds.test_in_batch, self.ds.test_out_batch)}).items():
            setattr(self.ds, f"{split}_in_batch", arrays[0])
            setattr(self.ds, f"{split}_out_batch", arrays[1])
        self.model = harness.import_attr(prog["model"])(dict(m, ds=self.ds), device=self.device)
        structure = self.model.init(torch.Generator(device=self.device).manual_seed(0))
        params = structure.with_tensors([torch.stack(ts) for ts in zip(*self.leaves)])
        self.noise_cls = harness.import_attr(prog["noise"])
        self.feed = Feed(self)
        self.trainer = harness.import_attr(prog["trainer"])(
            self.model, os.path.join(self.tmp, "model"), n_seeds=self.n_lanes, seed=self.seed,
            init_params=params, noise_fn=self.feed,
            epochs_per_dispatch=int(m["epochs_per_dispatch"]))
        self.steps_per_epoch = -(-self.ds.train_in_batch.shape[0] // int(m["batch_size"]))

    def setup(self, steps_only=False):
        """Build the lane program and run its ``train`` on the set-up's
        windows until the first ``check_steps`` steps are done, each
        read; with ``steps_only`` stop there (a calibration's readings).
        Returns the readings a lane."""
        self.build()
        tr = self.trainer
        readings = {"losses": []}
        p0 = [torch.stack(ts) for ts in zip(*self.leaves)]
        orig = tr.train_step

        def step(u, y, w, noises):
            losses, applied = orig(u, y, w, noises)
            k = len(readings["losses"])
            if k < self.n_check:
                readings["losses"].append(losses)
                if k == 0:
                    readings["g1"] = [m / (1.0 - common.BETA1) for m in tr.opt.exp_avg]
                if k == self.n_check - 1:
                    readings["p_last"] = [p.detach().clone() for p in tr.params.tensors()]
                    if steps_only:
                        raise StopWindow()
            return losses, applied

        tr.train_step = step
        batch = int(self.cfg["model"]["batch_size"])
        epochs = -(-self.n_check // -(-len(self.warm_rows) // batch))
        self.feed.phase = "setup"
        with contextlib.redirect_stdout(sys.stderr):
            try:
                tr.train(self.warm_dataset(), epochs)
            except StopWindow:
                tr.saver.flush(tr.model_dir)
        del tr.train_step
        sync(self.device)
        losses = torch.stack(readings["losses"]).double().cpu()  # [steps, lanes]
        return [{"losses": losses[:, lane].tolist(),
                 "grad": [g[lane].detach().double().cpu() for g in readings["g1"]],
                 "change": [(a[lane].double() - b[lane].double()).cpu()
                            for a, b in zip(readings["p_last"], p0)]}
                for lane in range(self.n_lanes)]

    def window(self, seconds: float, trace: bool):
        """The measured window, as the training mix's; traced, the
        program's spans too."""
        tr = self.trainer
        n_logged = len(tr.train_all)
        self.check_noise = [[[t.cpu() for t in n] for n in step] for step in self.check_noise]
        sync(self.device)
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        span, record_spans, phases = _program_profiling()
        feed = self.feed
        t0 = feed.begin_window(seconds, trace)
        with contextlib.redirect_stdout(sys.stderr), \
                (record_spans() if trace else contextlib.nullcontext()) as recorded:
            with span("benchmark.window"):
                try:
                    tr.train(self.ds, 10 ** 9, retrain=True)
                except StopWindow:
                    pass
        sync(self.device)
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if self.device == "cuda" else 0
        steps = feed.window_epochs * self.steps_per_epoch
        # lane-epochs logged in the window whose train or test loss is not finite
        bad = [~(np.isfinite(a) & np.isfinite(b))
               for a, b in zip(tr.train_all[n_logged:], tr.test_all[n_logged:])]
        self.nonfinite = int(sum(b.sum() for b in bad))
        self.failed_epochs = sum(bool(b.any()) for b in bad)
        summary = None
        if trace:
            summary = feed.trace.summary
            if summary is None:
                raise RuntimeError("the window ended before its traced span")
            first, last = feed.trace_span
            untraced = (first + feed.window_epochs - last) * self.steps_per_epoch
            summary["step_s"] = (feed.untraced_s + t1 - feed.resumed) / untraced
            names = [s[0] for s in recorded]
            win, on, off = (recorded[names.index(n)] for n in (
                "benchmark.window", "benchmark.trace_start", "benchmark.trace_stop"))
            summary.update(spans.summarize(recorded, phases, [(win[2], on[2]), (off[3], win[3])],
                                           feed.trace.events))
            feed.trace.events = None
        counts = getattr(tr, "counts", None)
        if counts is not None:
            print(f"program counts: {counts()}", file=sys.stderr)
        return {"steps": steps, "seconds": t1 - t0, "peak_bytes": peak, "trace": summary}

    # --- the reference -------------------------------------------------------

    def reference(self, prec: common.Precision):
        """Each lane's readings over its first steps: its weights, its
        rows by the lane shuffle rule over the set-up's windows, and its
        draws (the last step's by the lane draw rule)."""
        u_all, y_all = self.windows["train"]
        batch = int(self.cfg["model"]["batch_size"])
        lr = float(self.cfg["model"]["learning_rate"])
        np_dtype = np.dtype(self.cfg["model"]["dtype"])
        rows = self.warm_rows
        per_lane = lanes.first_lane_batches(self.seed, len(rows), batch, self.n_check,
                                            self.n_lanes)

        def loss_fn(leaves, u, y, w, noise, p):
            return self.ref.loss(self.cfg, leaves, u, y, w, noise, p)

        out = []
        for lane in range(self.n_lanes):
            noises = [[t.to(self.device) for t in step[lane]] for step in self.check_noise]
            noises.append(lanes.lane_draws(self.shapes, self.seed, self.drawn_at[0], 0, lane,
                                           self.drawn_at[1], self.dtype, self.device))
            batches = [(u_all[rows[idx]].astype(np_dtype), y_all[rows[idx]].astype(np_dtype),
                        w, noise) for (idx, w), noise in zip(per_lane[lane], noises)]
            losses, g1, last = common.follow(loss_fn, self.leaves[lane], batches, lr, prec)
            out.append({"losses": losses, "grad": [g.double().cpu() for g in g1],
                        "change": [(a.double() - b.double()).cpu()
                                   for a, b in zip(last, self.leaves[lane])]})
        return out


def compare(program: list, reference: list) -> dict:
    """The worst lane's :func:`benchmark.mixes.train.compare` numbers."""
    gaps = [train.compare(p, r) for p, r in zip(program, reference)]
    return {k: max(g[k] for g in gaps) for k in gaps[0]}


def measure(cell, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """One run of a lane cell: set-up, the window, the check."""
    run = Run(cell, seed, device)
    marks = [("start", harness.seconds_since_process_start())]
    try:
        run.make_inputs()
        marks.append(("inputs", harness.seconds_since_process_start()))
        program = run.setup()
        setup_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        # the first timed step is issued right after this
        setup_s = harness.seconds_since_process_start()
        marks.append(("set-up", setup_s))
        win = run.window(seconds, trace)
        marks.append(("window", harness.seconds_since_process_start()))
        run.free_program()
        reference = run.reference(common.Precision(torch.float64))
        marks.append(("reference", harness.seconds_since_process_start()))
    finally:
        run.close()
    print("phases (s since process start): " + ", ".join(f"{k} {v:.2f}" for k, v in marks)
          + f"; window {win['seconds']:.3f} s, {win['steps']} lane steps of "
          f"{run.n_lanes} lanes", file=sys.stderr)
    checks = harness.checks(compare(program, reference), cell.cfg["limits"])
    checks["window_nonfinite"] = {"value": run.nonfinite, "limit": 0}
    summary = win["trace"]
    if summary is not None:
        # a lane step's analytic operations: every lane's
        summary.update(gflop_per_step=run.n_lanes * run.ref.gflop_per_step(cell.cfg),
                       cfg=cell.cfg)
        by_step = spans.per_step(summary)
        if by_step:
            print("span ms / kernels a lane step: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(by_step.items())), file=sys.stderr)
    return {
        "values": {"setup_s": setup_s, "train_steps_per_s": win["steps"] / win["seconds"],
                   "train_peak_mem_gib": win["peak_bytes"] / harness.GIB},
        "attempted": win["steps"], "failed": run.failed_epochs * run.steps_per_epoch,
        "checks": checks, "peak_bytes": max(setup_peak, win["peak_bytes"]), "summary": summary,
    }

