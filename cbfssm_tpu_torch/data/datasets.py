"""The ``.mat`` datasets that ship in the repository (port of
``DSManagerDS``, ``RoboMove``, ``RoboMoveSimple`` and ``SpringNonlinear``
of ``cbfssm_tpu/data/datasets.py``): same dims, split points and
normalization."""

from __future__ import annotations

import os

from cbfssm_tpu_torch.data.base import BaseDS
from cbfssm_tpu_torch.data.ds_manager import DSManager


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
