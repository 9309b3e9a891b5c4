"""Loaders for the PR-SSM system-identification benchmark files (port of
``cbfssm_tpu/data/system_id_tasks.py``; numpy and scipy on the host).
Each task reads its raw file and splits train/test at the published
split point:

  Actuator  actuator.mat    (u, p)        split 512
  Ballbeam  ballbeam.dat    cols 0/1      split 500
  Drive     drive.mat       (u1, z1)      split 250
  Furnace   gas_furnace.csv cols 0/1      split 148
  Dryer     dryer.dat       cols 0/1      split 500
  Sarcos    sarcos_inv.mat  674-step experiments, torques (21:28) ->
            positions (0:7), experiments 0-59 train / 60-65 test,
            downsampled x2

Loaded data are lists of 2-D [time, dim] arrays, one per experiment.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import scipy.io

from cbfssm_tpu_torch.data.base import DEFAULT_DATA_DIR

_DATA_DIR = str(DEFAULT_DATA_DIR)


@dataclass
class TaskData:
    train_in: list = field(default_factory=list)
    train_out: list = field(default_factory=list)
    test_in: list = field(default_factory=list)
    test_out: list = field(default_factory=list)
    dt: float = 1.0


def _as_2d(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    return a[:, None] if a.ndim == 1 else a


def resample(data: np.ndarray, factor: float) -> np.ndarray:
    """Cubic up/downsampling of a [N, D] series along time by ``factor``
    (>1 upsamples), as the PR-SSM task framework resamples."""
    from scipy import interpolate

    n = data.shape[0]
    x = np.linspace(1, n, n)
    x_new = np.linspace(1, n, int(n * factor))
    return interpolate.interp1d(x, data, kind="cubic", axis=0)(x_new)


def resample_task(task: "TaskData", factor: float) -> "TaskData":
    """Resample every experiment of a task."""
    return TaskData(
        train_in=[resample(a, factor) for a in task.train_in],
        train_out=[resample(a, factor) for a in task.train_out],
        test_in=[resample(a, factor) for a in task.test_in],
        test_out=[resample(a, factor) for a in task.test_out],
        dt=task.dt / factor,
    )


def validate_task(task: "TaskData", name: str = "task") -> "TaskData":
    """Data-consistency checks (channel counts, shapes, lengths,
    finiteness), so that a malformed raw file fails here with a clear
    message instead of deep inside windowing or the model."""
    for split in ("train", "test"):
        ins = getattr(task, split + "_in")
        outs = getattr(task, split + "_out")
        if len(ins) != len(outs):
            raise ValueError(
                f"{name}: {split} has {len(ins)} input but {len(outs)} "
                "output experiments"
            )
        if not ins:
            raise ValueError(f"{name}: {split} split is empty")
        for i, (u, y) in enumerate(zip(ins, outs)):
            if u.ndim != 2 or y.ndim != 2:
                raise ValueError(
                    f"{name}: {split} experiment {i} must be 2-D "
                    f"[time, dim], got {u.shape} / {y.shape}"
                )
            if u.shape[0] != y.shape[0]:
                raise ValueError(
                    f"{name}: {split} experiment {i}: input length "
                    f"{u.shape[0]} != output length {y.shape[0]}"
                )
            if u.shape[0] == 0:
                # a raw file shorter than its published split point
                # produces a zero-length experiment; fail here, not in
                # windowing
                raise ValueError(
                    f"{name}: {split} experiment {i} has zero length — "
                    "the raw file is likely truncated (shorter than the "
                    "published train/test split point)"
                )
            if u.shape[1] != ins[0].shape[1] or y.shape[1] != outs[0].shape[1]:
                raise ValueError(
                    f"{name}: {split} experiment {i} channel count differs "
                    f"from experiment 0 ({u.shape[1]} vs {ins[0].shape[1]} in, "
                    f"{y.shape[1]} vs {outs[0].shape[1]} out)"
                )
            if u.shape[0] != ins[0].shape[0]:
                # the published layouts slice equal-length experiments; a
                # ragged tail block means a truncated raw file and would
                # crash np.asarray downstream with an obscure
                # 'inhomogeneous shape' error
                raise ValueError(
                    f"{name}: {split} experiment {i} length {u.shape[0]} "
                    f"differs from experiment 0 ({ins[0].shape[0]}) — raw "
                    "file likely truncated"
                )
            if not (np.isfinite(u).all() and np.isfinite(y).all()):
                raise ValueError(
                    f"{name}: {split} experiment {i} contains non-finite values"
                )
    du = task.train_in[0].shape[1]
    dy = task.train_out[0].shape[1]
    if task.test_in[0].shape[1] != du or task.test_out[0].shape[1] != dy:
        raise ValueError(
            f"{name}: test channel counts ({task.test_in[0].shape[1]}, "
            f"{task.test_out[0].shape[1]}) differ from train ({du}, {dy})"
        )
    return task


def _split_task(data_in, data_out, split_point, dt=1.0, name="task") -> TaskData:
    data_in = _as_2d(data_in)
    data_out = _as_2d(data_out)
    task = TaskData(
        train_in=[data_in[:split_point]],
        train_out=[data_out[:split_point]],
        test_in=[data_in[split_point:]],
        test_out=[data_out[split_point:]],
        dt=dt,
    )
    return validate_task(task, name)


def load_actuator(data_dir=_DATA_DIR) -> TaskData:
    data = scipy.io.loadmat(os.path.join(data_dir, "actuator.mat"))
    return _split_task(data["u"], data["p"], 512, name="actuator")


def load_ballbeam(data_dir=_DATA_DIR) -> TaskData:
    data = np.loadtxt(os.path.join(data_dir, "ballbeam.dat"))
    return _split_task(data[:, 0], data[:, 1], 500, dt=0.1, name="ballbeam")


def load_drive(data_dir=_DATA_DIR) -> TaskData:
    data = scipy.io.loadmat(os.path.join(data_dir, "drive.mat"))
    return _split_task(data["u1"], data["z1"], 250, name="drive")


def load_furnace(data_dir=_DATA_DIR) -> TaskData:
    data = np.loadtxt(os.path.join(data_dir, "gas_furnace.csv"), skiprows=1, delimiter=",")
    return _split_task(data[:, 0], data[:, 1], 148, name="furnace")


def load_dryer(data_dir=_DATA_DIR) -> TaskData:
    data = np.loadtxt(os.path.join(data_dir, "dryer.dat"))
    return _split_task(data[:, 0], data[:, 1], 500, name="dryer")


def load_sarcos(data_dir=_DATA_DIR) -> TaskData:
    """Forward dynamics: 7 joint torques (cols 21:28) -> 7 joint
    positions (cols 0:7), per-experiment blocks of 674 samples,
    downsampled by 2."""
    raw = scipy.io.loadmat(os.path.join(data_dir, "sarcos_inv.mat"))["sarcos_inv"]
    raw = raw.astype(np.float64)
    h_exp = 674
    downsample = 2
    exps = [raw[i : i + h_exp] for i in range(0, raw.shape[0], h_exp)]
    exps = [e[::downsample] for e in exps]
    input_ind = list(range(21, 28))
    output_ind = list(range(0, 7))
    task = TaskData(dt=0.01 * downsample)
    for i, e in enumerate(exps):
        if i < 60:
            task.train_in.append(e[:, input_ind])
            task.train_out.append(e[:, output_ind])
        elif i < 66:
            task.test_in.append(e[:, input_ind])
            task.test_out.append(e[:, output_ind])
    return validate_task(task, "sarcos")


TASK_LOADERS = {
    "actuator": load_actuator,
    "ballbeam": load_ballbeam,
    "drive": load_drive,
    "furnace": load_furnace,
    "dryer": load_dryer,
    "sarcos": load_sarcos,
}
