"""Evaluation artifacts (port of ``cbfssm_tpu/outputs/outputs.py``).

The same API (``Outputs(out_dir)``, ``set_ds`` / ``set_model`` /
``set_trainer`` / ``create_all`` / ``get_last_rmse``) and the same files:

  training_loss.pdf    loss curves over epochs
  predict_{train,test}.pdf/.mat
                       free-running prediction (condition=False) on the
                       first 300 steps of train/test experiment 0, with
                       1.96-sigma band, denormalized
  mse.txt              free-running test MSE/RMSE over full experiments
  calibration.txt      predictive NLL and interval coverage (calibration.py)
  var_dump.txt         all hyper/variational parameters

Predictions run under ``torch.inference_mode()`` on the model's device,
with a generator seeded from ``seed``; params that require grad (a
trainer's) therefore take the serving kernel, not the residual one.
``matplotlib`` and ``scipy.io`` are imported by the methods that write
plots and ``.mat`` files only.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from cbfssm_tpu_torch import model_store
from cbfssm_tpu_torch.outputs import calibration as cal
from cbfssm_tpu_torch.training import checkpoint

_BAND_COLOR = (255.0 / 255.0, 178.0 / 255.0, 110.0 / 255.0)


def pyplot():
    """matplotlib's pyplot on the file-only Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Outputs:
    def __init__(self, out_dir: str, seed: int = 0):
        self.out_dir = out_dir
        self.ds = None
        self.model = None
        self.model_dir = None
        self.trainer = None
        self.params = None
        self.last_rmse = None
        self.last_calibration = None
        self._test_preds = None  # shared test_mse/calibration pass
        self.seed = seed
        os.makedirs(out_dir, exist_ok=True)

    # --- wiring -------------------------------------------------------------

    def set_ds(self, ds):
        self.ds = ds

    def set_model(self, model, model_dir):
        self.model = model
        self.model_dir = model_dir

    def set_trainer(self, trainer):
        self.trainer = trainer

    def get_last_rmse(self):
        return self.last_rmse

    # --- generation -----------------------------------------------------------

    def _restore_params(self):
        """Best-checkpoint parameters, with or without a trainer."""
        best = os.path.join(self.model_dir, checkpoint.BEST)
        if self.trainer is not None:
            if checkpoint.exists(best):
                return self.trainer.restore(checkpoint.BEST)
            if self.trainer.params is not None:
                return self.trainer.params
        if checkpoint.exists(best):
            return model_store.restore_params(self.model, best, self.seed)
        raise RuntimeError(f"no trained parameters: neither a trainer nor {best} available")

    def create_all(self, params=None):
        """Generate every artifact. ``params`` overrides the default
        best-checkpoint restore."""
        if self.model is None or self.ds is None:
            raise RuntimeError("create_all needs set_model and set_ds first")
        self.params = self._restore_params() if params is None else params
        self._test_preds = None  # params may have changed
        print("Generating outputs...")
        self._create_all()

    def _create_all(self):
        self.training_stats()
        self.prediction()
        self.test_mse()
        self.calibration()
        self.var_dump()

    def _predict(self, u, y, condition=False):
        """Free-running prediction of [1, T, *] windows -> numpy (mean, var)."""
        with torch.inference_mode():
            gen = torch.Generator(device=self.model.device).manual_seed(self.seed)
            out = self.model.predict(self.params, u, y, gen, condition=condition)
            return out.pred_mean.cpu().numpy(), out.pred_var.cpu().numpy()

    # --- artifacts ----------------------------------------------------------

    def training_stats(self):
        if self.trainer is None:
            return
        print("  training stats")
        plt = pyplot()
        plt.figure(1)
        plt.plot(self.trainer.train_all, label="train")
        plt.plot(self.trainer.test_all, label="test")
        plt.legend()
        plt.savefig(os.path.join(self.out_dir, "training_loss.pdf"))
        plt.close(1)

    def _plot_prediction(self, name: str, data_in, data_out, predict_size: int):
        import scipy.io

        predict_size = min(predict_size, data_out.shape[1])
        pred, var = self._predict(data_in, data_out, condition=False)
        pred = self.ds.denormalize(pred, "out")[0]
        gt = self.ds.denormalize(data_out, "out")[0]
        std = self.ds.denormalize(np.sqrt(var), "out", shift=False)[0]
        lower = pred[:, 0] - 1.96 * std[:, 0]
        upper = pred[:, 0] + 1.96 * std[:, 0]

        plt = pyplot()
        plt.figure(1, figsize=(6, 4))
        plt.plot(gt[:, 0], label="ground truth")
        plt.plot(pred[:, 0], label="prediction")
        plt.fill_between(range(predict_size), lower, upper, color=_BAND_COLOR)
        plt.legend(loc=2)
        plt.grid(True)
        plt.xlabel("time (steps)")
        plt.xlim([0, predict_size])
        plt.savefig(os.path.join(self.out_dir, f"predict_{name}.pdf"), bbox_inches="tight")
        plt.close(1)

        scipy.io.savemat(
            os.path.join(self.out_dir, f"predict_{name}.mat"),
            {"mean": pred, "std": std, "gt": gt},
        )

    def prediction(self, predict_size: int = 300):
        print("  prediction")
        ds = self.ds
        # clamp each split on its own: a short train experiment must not
        # cut the test artifact's 300-step window
        train_size = min(ds.train_in.shape[1], predict_size)
        self._plot_prediction("train", ds.train_in[0:1, :train_size, :],
                              ds.train_out[0:1, :train_size, :], train_size)
        test_size = min(ds.test_in.shape[1], predict_size)
        self._plot_prediction("test", ds.test_in[0:1, :test_size, :],
                              ds.test_out[0:1, :test_size, :], test_size)

    def _test_predictions(self):
        """One free-run prediction pass over every test experiment,
        shared by test_mse and calibration: [(mean, std, gt)]
        denormalized, cached until params change."""
        if self._test_preds is None:
            ds = self.ds
            preds = []
            for i in range(ds.test_in.shape[0]):
                pred, var = self._predict(ds.test_in[i:i + 1], ds.test_out[i:i + 1],
                                          condition=False)
                mean = ds.denormalize(pred, "out")[0]
                std = ds.denormalize(np.sqrt(var), "out", shift=False)[0]
                gt = ds.denormalize(ds.test_out[i:i + 1], "out")[0]
                preds.append((mean, std, gt))
            self._test_preds = preds
        return self._test_preds

    def test_mse(self):
        print("  test mse")
        mse_all = [float(np.mean((gt - mean) ** 2)) for mean, _, gt in self._test_predictions()]
        mse = float(np.mean(mse_all))
        rmse = math.sqrt(mse)
        with open(os.path.join(self.out_dir, "mse.txt"), "w") as f:
            f.write("MSE:  %f\n" % mse)
            f.write("RMSE: %f\n" % rmse)
        self.last_rmse = rmse

    def calibration(self, levels=None):
        """calibration.txt: predictive NLL and central-interval coverage
        of the free-run Gaussian the prediction artifacts draw. Returns
        and stores the stats dict (``self.last_calibration``)."""
        print("  calibration")
        levels = cal.LEVELS if levels is None else levels
        parts = [cal.summarize(mean, np.square(std), gt, levels)
                 for mean, std, gt in self._test_predictions()]
        stats = cal.accumulate(parts)
        with open(os.path.join(self.out_dir, "calibration.txt"), "w") as f:
            f.write(cal.format_report(stats))
        self.last_calibration = stats
        return stats

    def var_dump(self):
        print("  var dump")
        with open(os.path.join(self.out_dir, "var_dump.txt"), "w") as f:
            for name, value in self.model.var_dict(self.params).items():
                value = np.atleast_1d(value.detach().cpu().numpy())
                f.write(name + ":\n")
                if value.ndim == 1:
                    for val in value:
                        f.write("  % .4e" % val)
                elif value.ndim == 2:
                    for row in value:
                        for val in row:
                            f.write("  % .4e" % val)
                        f.write("\n")
                f.write("\n\n")
