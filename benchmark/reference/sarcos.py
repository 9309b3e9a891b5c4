"""CBF-SSM on the Sarcos 7-DoF arm (``run/run_sarcos.py`` of
silvanmelchior/CBF-SSM) in plain PyTorch: the data it trains on here
and its data layer. The model is CBF-SSM, so the weights, draws, loss
and analytic operations are :mod:`benchmark.reference.cbfssm`'s, which
is general in dim_x, dim_u and dim_y.

- :func:`make_raw`: data in the layout of ``sarcos_inv.mat`` (66
  experiments of 674 rows x 28 columns: joint positions in 0:7,
  velocities 7:14, accelerations 14:21, torques 21:28), which is not in
  the repository. Each joint of each experiment follows a sum of a few
  seeded sinusoids, and its torque is that trajectory's inverse
  dynamics, one joint at a time (inertia x acceleration + damping x
  velocity + gravity x sin(position)), plus small measurement noise: a
  smooth log that the k-factor conditioning can follow, not white
  noise.
- :func:`windows`: the data layer (the program's ``SystemIdDS`` for
  Sarcos): experiments 0-59 train, 60-65 test, every second row,
  z-scored with the training split's statistics, windows of ``seq_len``
  every ``seq_stride`` rows of each experiment plus its tail window,
  experiment after experiment.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import scipy.io

from benchmark.reference.cbfssm import (LEAVES, gflop_per_step, init, loss,  # noqa: F401
                                        noise_shapes, rnn_windows)

# --- data ------------------------------------------------------------------


def make_raw(cfg, seed: int) -> dict:
    """``{'sarcos_inv': [experiments x rows, 28]}``, drawn in bulk from
    ``seed``."""
    d = cfg["data"]
    n_exp, n_row, joints = int(d["experiments"]), int(d["experiment_rows"]), int(d["dim_y"])
    sines = int(d["sines"])
    rng = np.random.default_rng(seed)
    t = np.arange(n_row) * float(d["dt"])
    amp = rng.uniform(*d["amplitude_rad"], (n_exp, joints, sines, 1))
    omega = 2.0 * np.pi * rng.uniform(*d["frequency_hz"], (n_exp, joints, sines, 1))
    phase = rng.uniform(0.0, 2.0 * np.pi, (n_exp, joints, sines, 1))
    offset = rng.uniform(-1.0, 1.0, (n_exp, joints, 1))
    arg = omega * t + phase  # [experiments, joints, sines, rows]
    pos = np.sum(amp * np.sin(arg), 2) + offset
    vel = np.sum(amp * omega * np.cos(arg), 2)
    acc = -np.sum(amp * omega ** 2 * np.sin(arg), 2)
    inertia, damping, gravity = (rng.uniform(lo, hi, (1, joints, 1)) for lo, hi in (
        d["inertia"], d["damping"], d["gravity"]))
    torque = inertia * acc + damping * vel + gravity * np.sin(pos)
    pos = pos + rng.normal(0.0, float(d["noise_pos"]), pos.shape)
    torque = torque + rng.normal(0.0, float(d["noise_torque"]), torque.shape)
    cols = np.concatenate((pos, vel, acc, torque), 1)  # [experiments, 28, rows]
    return {"sarcos_inv": cols.transpose(0, 2, 1).reshape(n_exp * n_row, 4 * joints)}


def write_raw(cfg, raw: dict, directory: str) -> None:
    """The data as the program's data layer reads it: ``sarcos_inv`` in
    ``cfg['data']['file']``."""
    scipy.io.savemat(f"{directory}/{cfg['data']['file']}", raw)


def windows(cfg, raw: dict) -> dict:
    """Train and test windows ``{'train': (u, y), 'test': (u, y)}`` of
    every experiment of each split."""
    d = cfg["data"]
    n_row, step = int(d["experiment_rows"]), int(d["downsample"])
    data = raw["sarcos_inv"].reshape(-1, n_row, raw["sarcos_inv"].shape[1])[:, ::step]
    u, y = data[..., slice(*d["u_columns"])], data[..., slice(*d["y_columns"])]
    n_train = int(d["train_experiments"])

    def zscore(a):
        flat = a[:n_train].reshape(-1, a.shape[-1])
        mean = flat.mean(0)
        return (a - mean) / (flat - mean).std(0)

    u, y = zscore(u), zscore(y)
    length, stride = int(d["seq_len"]), int(d["seq_stride"])

    def split(a, exps):
        return np.concatenate([rnn_windows(e, length, stride) for e in a[exps]])

    train, test = slice(0, n_train), slice(n_train, None)
    return {"train": (split(u, train), split(y, train)), "test": (split(u, test), split(y, test))}
