"""Multi-run RMSE aggregation (port of ``OutputSummary`` of
``cbfssm_tpu/outputs/summary.py``): copies the invoking script into the
output directory and writes per-run / mean / std RMSE to summary.txt,
plus per-run predictive NLL and 95%-band coverage when the runs produced
calibration stats; ``serial_reproduction``, the multi-iteration loop of
the system-identification drivers, and ``vmapped_reproduction``, the
same flow with all seeds trained as one lane-batched program."""

from __future__ import annotations

import os
import sys
from shutil import copyfile

import numpy as np


class OutputSummary:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.rmse_all = []
        self.calibration_all = []
        os.makedirs(out_dir, exist_ok=True)
        script = os.path.abspath(sys.argv[0])
        if os.path.isfile(script):
            copyfile(script, os.path.join(out_dir, "main.py"))

    def add_outputs(self, outputs):
        self.rmse_all.append(outputs.get_last_rmse())
        self.calibration_all.append(getattr(outputs, "last_calibration", None))

    def write_summary(self):
        if not self.rmse_all or self.rmse_all[0] is None:
            print("RMSE summary skipped")
            return
        rmse = np.asarray(self.rmse_all, dtype=np.float64)
        with open(os.path.join(self.out_dir, "summary.txt"), "w") as f:
            f.write("RMSE\n====\n\n")
            f.write("Runs:\n")
            for val in rmse:
                f.write("  %f\n" % val)
            f.write("Mean: %f\n" % np.mean(rmse))
            f.write("Std:  %f\n" % np.std(rmse))
            if all(c is not None for c in self.calibration_all):
                nll = np.asarray([c["nll"] for c in self.calibration_all], dtype=np.float64)
                cov = np.asarray([c["coverage"].get(0.95, np.nan) for c in self.calibration_all],
                                 dtype=np.float64)
                f.write("\nNLL/point\n=========\n\n")
                f.write("Runs:\n")
                for val in nll:
                    f.write("  %f\n" % val)
                f.write("Mean: %f\n" % np.mean(nll))
                f.write("Std:  %f\n" % np.std(nll))
                f.write("\n95%%-band coverage mean: %f\n" % np.mean(cov))


def serial_reproduction(make_model, make_ds, root, iterations, epochs_fn, metrics=False):
    """The serial multi-iteration flow of the run drivers: per iteration
    a dataset (``make_ds()``), a model (``make_model()``),
    ``Trainer(seed=it)`` and ``Outputs`` into ``root`` (one iteration)
    or ``root/run_<it>``; then summary.txt. ``epochs_fn(ds)`` gives an
    iteration's epochs; ``metrics`` writes each run's metrics.jsonl."""
    from cbfssm_tpu_torch.outputs.outputs import Outputs
    from cbfssm_tpu_torch.training import Trainer

    summary = OutputSummary(root)
    for it in range(iterations):
        if iterations != 1:
            print("\n=== Iteration %d ===\n" % it)
        out_dir = root if iterations == 1 else root + "/run_%d" % it
        outputs = Outputs(out_dir)
        ds = make_ds()
        outputs.set_ds(ds)
        model = make_model()
        outputs.set_model(model, out_dir)
        trainer = Trainer(model, out_dir, seed=it,
                          metrics_path=out_dir + "/metrics.jsonl" if metrics else None)
        trainer.train(ds, epochs_fn(ds))
        outputs.set_trainer(trainer)
        outputs.create_all()
        summary.add_outputs(outputs)
    summary.write_summary()
    return summary


def vmapped_reproduction(model, ds, root, iterations, epochs, outputs_cls=None,
                         metrics_path=None):
    """The multi-iteration flow with all seeds trained as one
    lane-batched program: ``MultiSeedTrainer`` (seeds 0 .. iterations-1
    as lanes), then per seed ``Outputs`` into ``root`` (one iteration)
    or ``root/run_<it>`` from the seed's view, then summary.txt: the
    artifact layout of :func:`serial_reproduction`. The drivers'
    ``vmap_seeds=True``."""
    from cbfssm_tpu_torch.outputs.outputs import Outputs
    from cbfssm_tpu_torch.training import MultiSeedTrainer

    outputs_cls = outputs_cls or Outputs
    summary = OutputSummary(root)
    trainer = MultiSeedTrainer(model, root, n_seeds=iterations, metrics_path=metrics_path)
    trainer.train(ds, epochs)
    for it in range(iterations):
        out_dir = root if iterations == 1 else root + "/run_%d" % it
        outputs = outputs_cls(out_dir)
        outputs.set_ds(ds)
        outputs.set_model(model, root)
        outputs.set_trainer(trainer.seed_view(it))
        outputs.create_all()
        summary.add_outputs(outputs)
    summary.write_summary()
    return summary
