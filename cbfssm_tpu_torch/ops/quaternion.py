"""Batched quaternion algebra, scalar first (w, x, y, z), on tensors
(port of ``cbfssm_tpu/ops/quaternion.py``)."""

from __future__ import annotations

import numpy as np
import torch

from cbfssm_tpu_torch.utils.transfer import constant

_CONJUGATE = np.array([1.0, -1.0, -1.0, -1.0])


def multiply(a, b):
    """Hamilton product of quaternion batches [..., 4] x [..., 4]."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        (
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ),
        dim=-1,
    )


def conjugate(q):
    """Quaternion conjugate (the inverse of a unit quaternion)."""
    return q * constant("quaternion.conjugate", lambda: _CONJUGATE, q.device, q.dtype)


def from_vector(v):
    """A 3-vector batch [..., 3] as pure quaternions [..., 4]."""
    return torch.cat((torch.zeros_like(v[..., :1]), v), dim=-1)


def rotate_vector(v, q):
    """Rotate the vectors ``v`` [..., 3] by the quaternions ``q``:
    the vector part of q * (0, v) * q^-1."""
    return multiply(multiply(q, from_vector(v)), conjugate(q))[..., 1:]


def normalize(q, dim=-1):
    """Unit-normalize quaternions along ``dim``."""
    return q / torch.linalg.vector_norm(q, dim=dim, keepdim=True)
