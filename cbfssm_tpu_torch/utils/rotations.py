"""Euler <-> quaternion / matrix conversions on the host, in numpy and
``scipy.spatial.transform.Rotation`` (a copy of
``cbfssm_tpu/utils/rotations.py``, which the port may not import).

The convention is intrinsic rotations about x, then the new y, then the
new z (scipy's ``'XYZ'``); quaternions are scalar first (w, x, y, z).
The functions are vectorized over leading batch dimensions.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

_INTRINSIC_XYZ = "XYZ"


def _quat_wxyz_to_xyzw(q):
    q = np.asarray(q, dtype=np.float64)
    return np.concatenate((q[..., 1:], q[..., :1]), axis=-1)


def _quat_xyzw_to_wxyz(q):
    return np.concatenate((q[..., 3:], q[..., :3]), axis=-1)


def euler_from_quaternion(quat_wxyz):
    """Intrinsic-XYZ Euler angles [..., 3] from wxyz quaternions [..., 4]."""
    q = _quat_wxyz_to_xyzw(quat_wxyz)
    angles = Rotation.from_quat(q.reshape(-1, 4)).as_euler(_INTRINSIC_XYZ)
    return angles.reshape(q.shape[:-1] + (3,))


def quaternion_from_euler(roll, pitch, yaw):
    """wxyz quaternions from intrinsic-XYZ Euler angles (broadcastable)."""
    angles = np.stack(np.broadcast_arrays(roll, pitch, yaw), axis=-1)
    q = Rotation.from_euler(_INTRINSIC_XYZ, angles.reshape(-1, 3)).as_quat()
    return _quat_xyzw_to_wxyz(q).reshape(angles.shape[:-1] + (4,))


def euler_matrix(roll, pitch, yaw):
    """3x3 rotation matrices [..., 3, 3] from intrinsic-XYZ Euler angles."""
    angles = np.stack(np.broadcast_arrays(roll, pitch, yaw), axis=-1)
    mats = Rotation.from_euler(_INTRINSIC_XYZ, angles.reshape(-1, 3)).as_matrix()
    return mats.reshape(angles.shape[:-1] + (3, 3))
