"""RoboMove evaluation: adds 2-D x/y trajectory plots (port of
``cbfssm_tpu/outputs/outputs_robomove.py``)."""

from __future__ import annotations

import os

from cbfssm_tpu_torch.outputs.outputs import Outputs, pyplot


class OutputsRoboMove(Outputs):
    def _create_all(self):
        super()._create_all()
        self.robomove_prediction()

    def _plot_trajectory(self, name: str, data_in, data_out, predict_size: int):
        pred, _ = self._predict(data_in, data_out, condition=False)
        pred = pred[0]
        plt = pyplot()
        plt.figure(1, figsize=(6, 5))
        plt.plot(data_out[0, :predict_size, 0], data_out[0, :predict_size, 1], "*-",
                 label="ground truth")
        plt.plot(pred[:, 0], pred[:, 1], "*-", label="prediction")
        plt.legend(loc=2)
        plt.axis("equal")
        plt.xticks([])
        plt.yticks([])
        plt.savefig(os.path.join(self.out_dir, f"robomove_{name}.pdf"), bbox_inches="tight")
        plt.close(1)

    def robomove_prediction(self, predict_size: int = 300):
        print("  robomove prediction")
        ds = self.ds
        predict_size = min(ds.train_in.shape[1], predict_size)
        self._plot_trajectory("train", ds.train_in[0:1, :predict_size, :],
                              ds.train_out[0:1, :predict_size, :], predict_size)
        self._plot_trajectory("test", ds.test_in[0:1, :predict_size, :],
                              ds.test_out[0:1, :predict_size, :], predict_size)
