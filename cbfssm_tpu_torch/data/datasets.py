"""The dataset classes (port of ``cbfssm_tpu/data/datasets.py``): the
system-identification tasks (``SystemIdDS``: Actuator, Ballbeam, Drive,
Furnace, Dryer, Sarcos), the single-file ``.mat`` datasets
(``DSManagerDS``: RoboMove, RoboMoveSimple, SpringNonlinear) and the
Voliro flight logs (``VoliroTiltDS``, ``VoliroFlipDS``), with the same
dims, split points and normalization. All produce [experiments, time,
dim] float64 arrays and windowed batches through
:class:`~cbfssm_tpu_torch.data.base.BaseDS`.
"""

from __future__ import annotations

import os

import numpy as np

from cbfssm_tpu_torch.data.base import BaseDS
from cbfssm_tpu_torch.data.ds_manager import DSManager
from cbfssm_tpu_torch.data.system_id_tasks import TASK_LOADERS
from cbfssm_tpu_torch.data.voliro_loader import VoliroLog
# the vehicle constants live on the model; no model module imports data
from cbfssm_tpu_torch.models.voliro import Voliro


class SystemIdDS(BaseDS):
    """Shared pipeline of the PR-SSM benchmark tasks: load, z-score with
    the train split's stats, window."""

    task_name: str | None = None

    def __init__(self, seq_len, seq_stride, data_dir=None):
        super().__init__(seq_len, seq_stride)
        if data_dir is not None:
            self.data_path = data_dir
        task = TASK_LOADERS[self.task_name](self.data_path)
        # Fail here on malformed staged files: a wrong channel count
        # would silently re-interleave samples in the reshape below, and
        # ragged experiment lengths crash np.asarray obscurely.
        for split, ins, outs in (("train", task.train_in, task.train_out),
                                 ("test", task.test_in, task.test_out)):
            for arrs, want, tag in ((ins, self.dim_u, "u"), (outs, self.dim_y, "y")):
                cols = {(np.asarray(a).shape[1] if np.asarray(a).ndim > 1 else 1)
                        for a in arrs}
                if cols != {want}:
                    raise ValueError(
                        f"{self.task_name}: staged {split} {tag}-data has "
                        f"{sorted(cols)} channel(s); this task needs {want}"
                    )
            lens = {np.asarray(a).shape[0] for a in ins}
            if len(lens) > 1:
                raise ValueError(
                    f"{self.task_name}: {split} experiments have unequal "
                    f"lengths {sorted(lens)}; staged raw file truncated?"
                )
        data_in = np.concatenate(task.train_in, axis=0).reshape(-1, self.dim_u)
        data_out = np.concatenate(task.train_out, axis=0).reshape(-1, self.dim_y)
        self.normalize_init(data_in, data_out)
        self.train_in = self.normalize(np.asarray(task.train_in), "in")
        self.train_out = self.normalize(np.asarray(task.train_out), "out")
        self.test_in = self.normalize(np.asarray(task.test_in), "in")
        self.test_out = self.normalize(np.asarray(task.test_out), "out")
        self.create_batches()


class Actuator(SystemIdDS):
    dim_u = 1
    dim_y = 1
    task_name = "actuator"


class Ballbeam(SystemIdDS):
    dim_u = 1
    dim_y = 1
    task_name = "ballbeam"


class Drive(SystemIdDS):
    dim_u = 1
    dim_y = 1
    task_name = "drive"


class Furnace(SystemIdDS):
    dim_u = 1
    dim_y = 1
    task_name = "furnace"


class Dryer(SystemIdDS):
    dim_u = 1
    dim_y = 1
    task_name = "dryer"


class Sarcos(SystemIdDS):
    dim_u = 7
    dim_y = 7
    task_name = "sarcos"


class DSManagerDS(BaseDS):
    """Single-experiment ``.mat`` datasets split at a fixed index
    (reference dsmanager_ds.py:6-27)."""

    filename: str | None = None
    split: int | None = None
    y_crop: int | None = None

    def __init__(self, seq_len, seq_stride, data_dir=None):
        super().__init__(seq_len, seq_stride)
        if data_dir is not None:
            self.data_path = data_dir
        u_data, _, y_data = DSManager.load_ds(os.path.join(self.data_path, self.filename))
        if self.y_crop is not None:
            y_data = y_data[:, : self.y_crop]
        self.normalize_init(u_data, y_data)
        u_data = self.normalize(u_data, "in")
        y_data = self.normalize(y_data, "out")
        split = self.split
        self.train_in = u_data[None, :split, :]
        self.train_out = y_data[None, :split, :]
        self.test_in = u_data[None, split:, :]
        self.test_out = y_data[None, split:, :]
        self.create_batches()


class RoboMoveSimple(DSManagerDS):
    dim_u = 2
    dim_y = 4
    filename = "robomove_simple.mat"
    split = 25000


class RoboMove(DSManagerDS):
    dim_u = 2
    dim_y = 2
    filename = "robomove.mat"
    split = 25000


class SpringNonlinear(DSManagerDS):
    dim_u = 1
    dim_y = 1
    filename = "spring_nonlinear.mat"
    split = 5000
    y_crop = 1


class VoliroDS(BaseDS):
    """Voliro flight-log dataset.

    u = [6 battery-scaled PWM, 6 tilt angles, time]  (dim_u = 13)
    y = [pos(3), linvel(3), linacc*m(3), rpy(3), quat(4), angvel(3),
         angacc*I(3)]                                 (dim_y = 22)

    Normalization is skipped (identity stats); the last window of every
    batch array is dropped (zero-padding guard).
    """

    dim_u = 13
    dim_y = 22

    # The dataset multiplies accelerations by mass and inertia and the
    # model divides by them: one source of truth, the model's.
    MASS = Voliro.MASS
    INERTIA = np.asarray(Voliro.INERTIA)

    def __init__(self, seq_len, seq_stride, data_dir=None):
        super().__init__(seq_len, seq_stride)
        if data_dir is not None:
            self.data_path = data_dir

        ds1 = VoliroLog(os.path.join(self.data_path, "voliro_tilt.mat"), 1500, 3800)
        u_data1, y_data1, battery1 = self._assemble(ds1)
        ds2 = VoliroLog(os.path.join(self.data_path, "voliro_flip.mat"), 17600, 20172)
        u_data2, y_data2, battery2 = self._assemble(ds2)

        # battery voltage influence on the delivered PWM thrust
        pwm_scale = np.sqrt(39.622609152 / 36.3063891724)
        battery_scale = battery2[0, 0]
        u_data1[:, :6] *= battery1 * pwm_scale / battery_scale
        u_data2[:, :6] *= battery2 * pwm_scale / battery_scale

        # identity normalization (raw physical units are kept)
        self.mean["in"] = np.zeros(self.dim_u)
        self.std["in"] = np.ones(self.dim_u)
        self.mean["out"] = np.zeros(self.dim_y)
        self.std["out"] = np.ones(self.dim_y)

        # print the stats after the last-window drop below, so that the
        # printed sequence counts are the ones that train
        self._defer_stats = True
        self._save(u_data1, y_data1, u_data2, y_data2)

        self.train_in_batch = self.train_in_batch[:-1]
        self.train_out_batch = self.train_out_batch[:-1]
        self.test_in_batch = self.test_in_batch[:-1]
        self.test_out_batch = self.test_out_batch[:-1]
        self._defer_stats = False
        self.print_stats()

    def print_stats(self) -> None:
        if getattr(self, "_defer_stats", False):
            return
        super().print_stats()

    def _assemble(self, log: VoliroLog):
        u = np.concatenate((log.pwmup, log.tilt, log.timesteps[:, None]), axis=1)
        y = np.concatenate(
            (log.pos, log.linvel, log.linacc * self.MASS, log.rpy, log.wxyz, log.angvel,
             log.angacc * self.INERTIA),
            axis=1,
        )
        return u, y, log.battery[:, None]

    def _save(self, u_data1, y_data1, u_data2, y_data2):
        raise NotImplementedError


class VoliroTiltDS(VoliroDS):
    """Train/test on the first/second half of the tilt log; the flip log
    is the transfer set (test_in2/test_out2)."""

    def _save(self, u_data1, y_data1, u_data2, y_data2):
        split = u_data1.shape[0] // 2
        self.train_in = u_data1[None, :split, :]
        self.train_out = y_data1[None, :split, :]
        self.test_in = u_data1[None, split:, :]
        self.test_out = y_data1[None, split:, :]
        self.test_in2 = u_data2[None]
        self.test_out2 = y_data2[None]
        self.create_batches()


class VoliroFlipDS(VoliroDS):
    """Train/test on the first/second half of the flip log; the tilt log
    is the transfer set."""

    def _save(self, u_data1, y_data1, u_data2, y_data2):
        split = u_data2.shape[0] // 2
        self.train_in = u_data2[None, :split, :]
        self.train_out = y_data2[None, :split, :]
        self.test_in = u_data2[None, split:, :]
        self.test_out = y_data2[None, split:, :]
        self.test_in2 = u_data1[None]
        self.test_out2 = y_data1[None]
        self.create_batches()
