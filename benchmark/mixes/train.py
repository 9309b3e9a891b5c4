"""The training mix (a traffic file with ``"mix": "train"``): one run of
a training cell, from set-up to the numbers compared.

Set-up makes the data, writes the raw files the program's data layer
reads and builds one ``Trainer`` (``cbfssm_tpu_torch.training.Trainer``)
on the port's model, with the weights made here (``init_params``) and a
feed (``noise_fn``) that hands the first ``check_steps`` steps but the
last their draws; the last checked step draws its own, from the
trainer's generator, as every step of the window does. ``Trainer.train``
then runs whole epochs until those steps are done, which builds the
kernel and warms every shape the window uses (train steps, the test
pass, logging, checkpoints). The window is a second ``Trainer.train`` of
the same trainer from its last checkpoint (``retrain=True``), in blocks
of the configured ``epochs_per_dispatch``; the feed ends it at the first
block boundary at or after ``--seconds``, and a device sync closes it.
With ``--trace 1`` the feed records ``trace_steps`` steps' epochs (whole
epochs, from the second block) under :class:`benchmark.tracing.Trace`,
and times the window's untraced epochs apart, for the per-layer metrics
that want the step time without the profiler.

The check: the reference follows the same first steps from the same
weights, rows and draws (the last step's worked out again by the
trainer's draw rule, :func:`benchmark.reference.common.trainer_draws`)
in float64, after the window, once the program's state is freed.
Compared (:func:`compare`): each step's loss, the first gradient's norm
per leaf (the program's from its Adam state after one step: the first
moment is 0.1 g), and each leaf's change over the steps.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import harness, tracing
from benchmark.reference import common


class StopWindow(Exception):
    """Raised inside ``Trainer.train`` where the window (or a
    calibration's set-up) ends."""


def seed_bits(seed: int) -> int:
    return int(seed) % (2 ** 63)


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


class Run:
    """One run's state: inputs, the program's trainer, readings."""

    def __init__(self, cell, seed: int, device: str = "cuda"):
        self.cell, self.cfg, self.ref = cell, cell.cfg, cell.ref
        self.seed = seed_bits(seed)
        self.device = device
        self.dtype = getattr(torch, self.cfg["model"]["dtype"])
        self.tmp = tempfile.mkdtemp(prefix="bench_")
        self.trainer = None

    def close(self):
        if self.trainer is not None:
            with contextlib.suppress(Exception):
                self.trainer.saver.flush(self.trainer.model_dir)
        self.trainer = None
        shutil.rmtree(self.tmp, ignore_errors=True)

    # --- inputs ------------------------------------------------------------

    def make_inputs(self):
        """The raw data (and its files for the program), the windows the
        reference reads, set-up's windows, the weights, the checked
        steps' draws but the last, and where the last step's batch sits
        (epoch, index), whose draws the trainer makes."""
        self.raw = self.ref.make_raw(self.cfg, self.seed)
        self.data_dir = os.path.join(self.tmp, "data")
        os.makedirs(self.data_dir)
        self.ref.write_raw(self.cfg, self.raw, self.data_dir)
        self.windows = self.ref.windows(self.cfg, self.raw)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.leaves = self.ref.init(self.cfg, gen, self.dtype, self.device)
        n_train, self.t_len = self.windows["train"][0].shape[:2]
        batch = int(self.cfg["model"]["batch_size"])
        self.n_check = int(self.cell.traffic["check_steps"])
        # set-up's windows: n_check batches of distinct training windows
        # (all of them where there are fewer)
        rows = np.random.default_rng([self.seed, 1]).choice(
            n_train, min(n_train, self.n_check * batch), replace=False)
        self.warm_rows = np.sort(rows)
        self.shapes = self.ref.noise_shapes(self.cfg, batch, self.t_len)
        self.check_noise = [common.draws(self.shapes, gen, self.dtype, self.device)
                            for _ in range(self.n_check - 1)]
        per_epoch = -(-len(self.warm_rows) // batch)
        self.drawn_at = divmod(self.n_check - 1, per_epoch)

    # --- the program ------------------------------------------------------------

    def build(self):
        prog = self.cfg["program"]
        package = importlib.import_module(prog["model"].split(".")[0])
        if not Path(package.__file__).resolve().is_relative_to(harness.ROOT):
            raise RuntimeError(f"{package.__name__} comes from {package.__file__}, outside "
                               f"the checkout {harness.ROOT}: the benchmark measures the "
                               f"checkout's")
        from cbfssm_tpu_torch.training import Trainer

        m, d = self.cfg["model"], self.cfg["data"]
        with contextlib.redirect_stdout(sys.stderr):
            self.ds = harness.import_attr(prog["dataset"])(
                int(d["seq_len"]), int(d["seq_stride"]), data_dir=self.data_dir)
        self.model = harness.import_attr(prog["model"])(dict(m, ds=self.ds), device=self.device)
        structure = self.model.init(torch.Generator(device=self.device).manual_seed(0))
        params = structure.with_tensors(self.leaves)
        self.noise_cls = harness.import_attr(prog["noise"])
        self.feed = Feed(self)
        self.trainer = Trainer(self.model, os.path.join(self.tmp, "model"), seed=self.seed,
                               init_params=params, noise_fn=self.feed,
                               epochs_per_dispatch=int(m["epochs_per_dispatch"]))
        self.steps_per_epoch = -(-self.ds.train_in_batch.shape[0] // int(m["batch_size"]))

    def warm_dataset(self):
        """The program's dataset cut to the set-up's windows
        (``warm_rows``) and one batch of test windows."""
        batch = int(self.cfg["model"]["batch_size"])
        warm = copy.copy(self.ds)
        warm.train_in_batch = self.ds.train_in_batch[self.warm_rows]
        warm.train_out_batch = self.ds.train_out_batch[self.warm_rows]
        warm.test_in_batch = self.ds.test_in_batch[:batch]
        warm.test_out_batch = self.ds.test_out_batch[:batch]
        return warm

    def setup(self, steps_only=False):
        """Build the trainer and run ``Trainer.train`` on the set-up's
        windows (:meth:`warm_dataset`) until the first ``check_steps``
        steps are done, each read: the kernel is built and every shape of
        the window warmed (train steps, the test pass, logging,
        checkpoints). With ``steps_only`` it stops after those steps (a
        calibration's readings, which need no window)."""
        self.build()
        tr = self.trainer
        readings = {"losses": [], "p0": [t.detach().clone() for t in self.leaves]}
        orig = tr.train_step

        def step(u, y, w, generator=None, noise=None):
            loss, applied = orig(u, y, w, generator, noise)
            k = len(readings["losses"])
            if k < self.n_check:
                readings["losses"].append(loss)
                if k == 0:
                    readings["g1"] = [tr.optimizer.state[p]["exp_avg"] / (1.0 - common.BETA1)
                                      for p in tr.params.tensors()]
                if k == self.n_check - 1:
                    readings["p_last"] = [p.detach().clone() for p in tr.params.tensors()]
                    if steps_only:
                        raise StopWindow()
            return loss, applied

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
        return {
            "losses": [float(t) for t in readings["losses"]],
            "grad": [g.detach().double().cpu() for g in readings["g1"]],
            "change": [(a.double() - b.double()).cpu()
                       for a, b in zip(readings["p_last"], readings["p0"])],
        }

    def window(self, seconds: float, trace: bool):
        """The measured window: ``Trainer.train`` from the set-up's last
        checkpoint, ended by the feed at the first block boundary at or
        after ``seconds``, closed by a device sync."""
        tr = self.trainer
        n_logged = len(tr.train_all)
        # the check's draws wait on the host: the window's peak is the program's
        self.check_noise = [[t.cpu() for t in n] for n in self.check_noise]
        sync(self.device)
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        feed = self.feed
        t0 = feed.begin_window(seconds, trace)
        with contextlib.redirect_stdout(sys.stderr):
            try:
                tr.train(self.ds, 10 ** 9, retrain=True)
            except StopWindow:
                pass
        sync(self.device)
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if self.device == "cuda" else 0
        steps = feed.window_epochs * self.steps_per_epoch
        # epochs logged in the window whose train or test loss is not finite
        self.nonfinite = sum(not (math.isfinite(a) and math.isfinite(b))
                             for a, b in zip(tr.train_all[n_logged:], tr.test_all[n_logged:]))
        summary = None
        if trace:
            summary = feed.trace.summary
            if summary is None:
                raise RuntimeError("the window ended before its traced span")
            # the untraced epochs: before the span and after it
            first, last = feed.trace_span
            untraced = (first + feed.window_epochs - last) * self.steps_per_epoch
            summary["step_s"] = (feed.untraced_s + t1 - feed.resumed) / untraced
        return {"steps": steps, "seconds": t1 - t0, "peak_bytes": peak, "trace": summary}

    def free_program(self):
        if self.trainer is not None:
            self.trainer.saver.flush(self.trainer.model_dir)
        self.trainer = self.model = self.ds = self.feed = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # --- the reference -------------------------------------------------------

    def reference(self, prec: common.Precision):
        """The reference's readings over the same first steps: the same
        weights, each step's rows by the trainer's shuffle rule over the
        set-up's windows, and its draws (the last step's by the trainer's
        draw rule)."""
        u_all, y_all = self.windows["train"]
        batch = int(self.cfg["model"]["batch_size"])
        lr = float(self.cfg["model"]["learning_rate"])
        np_dtype = np.dtype(self.cfg["model"]["dtype"])
        rows = self.warm_rows
        noises = [[t.to(self.device) for t in n] for n in self.check_noise]
        noises.append(common.trainer_draws(
            self.shapes, self.seed, self.drawn_at[0], 0, self.drawn_at[1], self.dtype,
            self.device))
        batches = []
        for (idx, w), noise in zip(common.first_batches(self.seed, len(rows), batch,
                                                        self.n_check), noises):
            # the data in the configuration's type, as the program holds it
            batches.append((u_all[rows[idx]].astype(np_dtype),
                            y_all[rows[idx]].astype(np_dtype), w, noise))

        def loss_fn(leaves, u, y, w, noise, p):
            return self.ref.loss(self.cfg, leaves, u, y, w, noise, p)

        losses, g1, last = common.follow(loss_fn, self.leaves, batches, lr, prec)
        return {"losses": losses, "grad": [g.double().cpu() for g in g1],
                "change": [(a.double() - b.double()).cpu() for a, b in zip(last, self.leaves)]}


class Feed:
    """The trainer's ``noise_fn``: it hands the checked steps their draws
    and, in the window, marks epochs, records the traced span, times the
    untraced epochs and ends the window. It sees every batch as it is
    issued: (epoch, split 0 train / 1 test, index)."""

    def __init__(self, run: Run):
        self.run = run
        self.phase = "setup"
        self.train_calls = 0
        self.trace = tracing.Trace()

    def begin_window(self, seconds: float, trace: bool):
        traffic = self.run.cell.traffic
        epd = int(self.run.cfg["model"]["epochs_per_dispatch"])
        self.phase, self.seconds, self.epd = "window", seconds, epd
        self.window_epochs = 0
        self.trace_span = None
        if trace:
            n = -(-int(traffic["trace_steps"]) // self.run.steps_per_epoch)
            self.trace_span = (epd, epd + n)  # from the second block
        self.counts = {0: 0, 1: 0}
        self.untraced_s = 0.0
        self.t0 = self.resumed = time.perf_counter()
        return self.t0

    def __call__(self, epoch, split, i, b, t_len):
        if self.phase == "setup":
            if split == 0:
                k, self.train_calls = self.train_calls, self.train_calls + 1
                if k < len(self.run.check_noise):
                    return self.run.noise_cls(*self.run.check_noise[k])
                if k == len(self.run.check_noise) and (epoch, i) != self.run.drawn_at:
                    raise RuntimeError(f"the last checked step is batch {i} of epoch {epoch}, "
                                       f"the reference reckons {self.run.drawn_at}")
            return None
        if split == 0 and i == 0:
            self._epoch_start(epoch)
        self.counts[split] += 1
        return None

    def _epoch_start(self, epoch):
        span = self.trace_span
        if span is not None and epoch == span[1] and self.trace.active:
            self.trace.stop()
            self.trace.summary.update(train_steps=self.counts[0], eval_batches=self.counts[1])
            self.resumed = time.perf_counter()
        traced = span is None or epoch >= span[1]
        if (epoch > 0 and epoch % self.epd == 0 and traced
                and time.perf_counter() - self.t0 >= self.seconds):
            self.window_epochs = epoch
            raise StopWindow()
        if span is not None and epoch == span[0]:
            sync(self.run.device)
            self.untraced_s = time.perf_counter() - self.t0
            self.trace.start()
            self.counts = {0: 0, 1: 0}


# --- the comparison ----------------------------------------------------------------


def _norms(leaves):
    return [float(torch.linalg.vector_norm(t)) for t in leaves]


def _worst_gap(prog, ref):
    """The worst leaf's |‖program‖ - ‖reference‖| over the larger of its
    reference norm and the median leaf's."""
    p, r = _norms(prog), _norms(ref)
    med = statistics.median(r)
    if not med > 0:
        return math.inf
    return max(abs(a - b) / max(b, med) if math.isfinite(a) else math.inf
               for a, b in zip(p, r))


def compare(program: dict, reference: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, the worst
    leaf of the first gradient and of the change over the steps, every
    leaf counted."""
    return {"loss": max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                        for p, r in zip(program["losses"], reference["losses"])),
            "grad": _worst_gap(program["grad"], reference["grad"]),
            "change": _worst_gap(program["change"], reference["change"])}


# --- a whole run --------------------------------------------------------------------


def measure(cell, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """One run of a training cell: set-up, the window, the check."""
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
          + f"; window {win['seconds']:.3f} s, {win['steps']} steps", file=sys.stderr)
    checks = harness.checks(compare(program, reference), cell.cfg["limits"])
    checks["window_nonfinite"] = {"value": run.nonfinite, "limit": 0}
    summary = win["trace"]
    if summary is not None:
        summary.update(gflop_per_step=run.ref.gflop_per_step(cell.cfg), cfg=cell.cfg)
    return {
        "values": {"setup_s": setup_s, "train_steps_per_s": win["steps"] / win["seconds"],
                   "train_peak_mem_gib": win["peak_bytes"] / harness.GIB},
        "attempted": win["steps"], "failed": run.nonfinite * run.steps_per_epoch,
        "checks": checks, "peak_bytes": max(setup_peak, win["peak_bytes"]), "summary": summary,
    }
