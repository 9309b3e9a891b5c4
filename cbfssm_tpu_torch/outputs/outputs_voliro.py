"""Voliro evaluation: physical-model against GP-corrected force plots
(port of ``cbfssm_tpu/outputs/outputs_voliro.py``).

Skips the generic prediction / test_mse artifacts and plots predicted
against estimated body forces (with uncertainty bands) on the
train+validate log and on the transfer log (test_in2 / test_out2):
``voliro_forces.pdf``, with the plotted arrays in ``voliro_forces.mat``
(as the generic outputs keep ``predict_*.mat`` beside their plots).
Each plotted log is one predict over the whole log: one batched
force-GP call, then one recognition-GP call per time step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cbfssm_tpu_torch.outputs.outputs import Outputs, pyplot


class OutputsVoliro(Outputs):
    def _create_all(self):
        self.training_stats()
        self.voliro_forces()
        self.var_dump()

    def _predict_voliro(self, u, y):
        """The model's predict dict on [1, T, *] logs, as numpy arrays."""
        with torch.inference_mode():
            gen = torch.Generator(device=self.model.device).manual_seed(self.seed)
            out = self.model.predict(self.params, u, y, gen, condition=True)
            return {k: v.cpu().numpy() for k, v in out.items()}

    def voliro_forces(self):
        print("  voliro forces")
        import scipy.io

        ds = self.ds
        data_in = np.concatenate((ds.train_in[0:1], ds.test_in[0:1]), axis=1)
        data_out = np.concatenate((ds.train_out[0:1], ds.test_out[0:1]), axis=1)
        out1 = self._predict_voliro(data_in, data_out)
        out2 = self._predict_voliro(ds.test_in2, ds.test_out2)
        scipy.io.savemat(
            os.path.join(self.out_dir, "voliro_forces.mat"),
            {f"{k}_{tag}": out[k][0] for tag, out in (("train", out1), ("transfer", out2))
             for k in ("force_torque", "ft_mean", "ft_var")},
        )
        self._plot_forces(out1, data_out[0], out2, ds.test_out2[0])

    def _plot_forces(self, out1, gt1, out2, gt2):
        from matplotlib.lines import Line2D

        plt = pyplot()
        fig = plt.figure(2, figsize=(12, 9))

        # top row: pure physical model against the estimated forces
        for i, (pred, gt) in enumerate(
            [(out1["force_torque"][0], gt1), (out2["force_torque"][0], gt2)]
        ):
            ax = fig.add_subplot(221 + i)
            for j, color in enumerate("rgb"):
                plt.plot(pred[:, j], color)
                plt.plot(gt[:, 6 + j], color + "--")
            if i == 0:
                plt.ylabel("Physical Model")
            if i == 1:
                force_lines = [Line2D([0], [0], color=c, lw=2) for c in "rgb"]
                leg1 = ax.legend(force_lines, ["x-force", "y-force", "z-force"], loc=4)
                style_lines = [
                    Line2D([0], [0], color="k", lw=2),
                    Line2D([0], [0], color="k", linestyle="--", lw=2),
                ]
                ax.legend(style_lines, ["prediction", "ref"], loc=3)
                ax.add_artist(leg1)
            plt.grid(True)
            plt.xlim([0, gt.shape[0]])

        # bottom row: GP-corrected forces with 1.96-sigma bands
        band = {"r": (1.0, 0.6, 0.6), "g": (0.6, 1.0, 0.6), "b": (0.6, 0.6, 1.0)}
        for i, (out, gt) in enumerate([(out1, gt1), (out2, gt2)]):
            plt.subplot(223 + i)
            mean, var = out["ft_mean"][0], out["ft_var"][0]
            for j, color in enumerate("rgb"):
                plt.plot(mean[:, j], color)
                sd = 1.96 * np.sqrt(var[:, j])
                plt.fill_between(range(mean.shape[0]), mean[:, j] - sd, mean[:, j] + sd,
                                 color=band[color])
                plt.plot(gt[:, 6 + j], color + "--")
            if i == 0:
                plt.axvline(x=self.ds.train_in.shape[1], color="k", linestyle="--")
                plt.title("Train, Validate")
                plt.ylabel("Physical Model + CBF-SSM")
            else:
                plt.title("Test")
            plt.grid(True)
            plt.xlim([0, gt.shape[0]])

        plt.savefig(os.path.join(self.out_dir, "voliro_forces.pdf"), bbox_inches="tight")
        plt.close(2)
