"""Voliro (overactuated drone) PX4 flight-log preprocessing (port of
``cbfssm_tpu/data/voliro_loader.py``; numpy and scipy on the host).

Parses a ``.mat`` log struct, crops an index range, and derives
position, attitude (yaw zeroed, then the unwrap filter), PWM, tilt
angles, Gaussian-smoothed signals, finite-difference linear and angular
velocity and acceleration (with gravity compensation), and battery
voltage. The arrays are those of the JAX package, bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.io
from scipy.ndimage import gaussian_filter1d

from cbfssm_tpu_torch.utils import rotations

_LOG_KEYS = [
    "TIME_StartTime",
    "LPOS_X",
    "LPOS_Y",
    "LPOS_Z",
    "ATT_qw",
    "ATT_qx",
    "ATT_qy",
    "ATT_qz",
    "ATC0_Out0",
    "ATC0_Out1",
    "ATC0_Out2",
    "ATC0_Out3",
    "ATC0_Out4",
    "ATC0_Out5",
    "ATC1_Out0",
    "ATC1_Out1",
    "ATC1_Out2",
    "ATC1_Out3",
    "ATC1_Out4",
    "ATC1_Out5",
    "ATC2_Out0",
    "ATC2_Out1",
    "ATC2_Out2",
    "ATC2_Out3",
    "ATC2_Out4",
    "ATC2_Out5",
    "BATT_VFilt",
]


def _quat_multiply(a, b):
    """Hamilton product of wxyz quaternion arrays [..., 4] in numpy."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        (
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ),
        axis=-1,
    )


def unwrap_euler_angles(vec: np.ndarray, threshold: float = 2.0 / 3.0 * np.pi) -> np.ndarray:
    """Jump filter for Euler-angle series [T] or [T, channels]: a
    positive jump above ``threshold`` between consecutive filtered
    samples subtracts 2*pi; a negative one adds pi, or 2*pi if the jump
    is still below -threshold."""
    vec = np.asarray(vec)
    # a 1-D series is one channel over time
    squeeze = vec.ndim == 1
    if squeeze:
        vec = vec[:, None]
    if vec.ndim != 2:
        raise ValueError(f"expected [T] or [T, channels] angle series, got {vec.shape}")
    out = np.zeros_like(vec)
    out[0] = vec[0]
    for k in range(vec.shape[1]):
        prev = out[0, k]
        col = vec[:, k]
        res = out[:, k]
        for i in range(1, vec.shape[0]):
            v = col[i]
            if v - prev > threshold:
                cand = v - 2 * np.pi
            elif v - prev < -threshold:
                cand = v + np.pi
                if cand - prev < -threshold:
                    cand = v + 2 * np.pi
            else:
                cand = v
            res[i] = cand
            prev = cand
    return out[:, 0] if squeeze else out


class VoliroLog:
    """One cropped flight log with all derived signals as attributes."""

    def __init__(self, ds_path: str, startidx: int, endidx: int):
        raw = scipy.io.loadmat(ds_path)["dataset"]
        ds = {k: np.asarray(raw[k][0][0]).T[0] for k in _LOG_KEYS}
        sl = slice(startidx, endidx)

        # position, zeroed at the crop start
        pos = np.stack((ds["LPOS_X"][sl], ds["LPOS_Y"][sl], ds["LPOS_Z"][sl]), axis=1)
        self.pos = pos - pos[0]

        # attitude: quat -> euler (yaw zeroed + unwrapped) -> clean quat
        wxyz_raw = np.stack(
            (ds["ATT_qw"][sl], ds["ATT_qx"][sl], ds["ATT_qy"][sl], ds["ATT_qz"][sl]), axis=1
        )
        rpy = rotations.euler_from_quaternion(wxyz_raw)
        rpy[:, 2] -= rpy[0, 2]
        self.rpy = unwrap_euler_angles(rpy)
        self.wxyz = rotations.quaternion_from_euler(self.rpy[:, 0], self.rpy[:, 1], self.rpy[:, 2])

        # rotor PWM (upper/lower rings) and rotor tilt angles
        self.pwmup = np.stack([ds[f"ATC0_Out{i}"][sl] for i in range(6)], axis=1)
        self.pwmlo = np.stack([ds[f"ATC1_Out{i}"][sl] for i in range(6)], axis=1)
        self.tilt = np.stack([ds[f"ATC2_Out{i}"][sl] for i in range(6)], axis=1)

        # time (the log stores microseconds)
        t = ds["TIME_StartTime"]
        self.dt = (t[endidx] - t[startidx]) / float((endidx - startidx) * 1_000_000)
        self.timesteps = t[sl] / 1_000_000.0

        # smoothed signals
        sigma = 25
        self.pos_smooth = gaussian_filter1d(self.pos, sigma, axis=0)
        self.rpy_smooth = gaussian_filter1d(self.rpy, sigma, axis=0)
        self.wxyz_smooth = gaussian_filter1d(self.wxyz, sigma, axis=0)

        # linear velocity: first difference of the smoothed position
        self.linvel = np.zeros_like(self.pos_smooth)
        self.linvel[1:] = np.diff(self.pos_smooth, axis=0) / self.dt

        # linear acceleration: first difference of velocity, with the
        # body-frame gravity component added back
        self.linacc = np.zeros_like(self.linvel)
        self.linacc[1:-1] = np.diff(self.linvel, axis=0)[1:] / self.dt
        g = np.asarray([0.0, 0.0, -9.81])
        rot = rotations.euler_matrix(self.rpy[:, 0], self.rpy[:, 1], self.rpy[:, 2])
        self.linacc += np.einsum("nji,j->ni", rot, g)  # R^T @ g per sample

        # angular velocity from the smoothed quaternion derivative:
        # omega = 2 * (dq/dt) * q^-1 (vector part)
        self.angvel = np.zeros_like(self.pos_smooth)
        dq = np.diff(self.wxyz_smooth, axis=0) / self.dt
        conj = self.wxyz_smooth[1:] * np.asarray([1.0, -1.0, -1.0, -1.0])
        om = 2.0 * _quat_multiply(dq, conj)
        self.angvel[1:] = om[:, 1:]

        # angular acceleration
        self.angacc = np.zeros_like(self.angvel)
        self.angacc[1:-1] = np.diff(self.angvel, axis=0)[1:] / self.dt

        # battery voltage (scaled)
        self.battery = ds["BATT_VFilt"][sl] / 25.0
