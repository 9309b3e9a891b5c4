"""ARD squared-exponential (RBF) kernel (port of
``cbfssm_tpu/ops/kernels.py``): k(x, x') = variance *
exp(-0.5 * || (x - x') / lengthscales ||^2)."""

from __future__ import annotations

import torch


def scaled_square_dist(x, z, lengthscales):
    """Pairwise squared distances of rows of ``x`` [N, D] and ``z``
    [M, D] after dividing each input dimension by its lengthscale
    -> [N, M], clamped at 0 against cancellation."""
    xs = x / lengthscales
    zs = z / lengthscales
    xn = torch.sum(torch.square(xs), dim=-1)
    zn = torch.sum(torch.square(zs), dim=-1)
    d2 = xn[:, None] - 2.0 * torch.matmul(xs, zs.T) + zn[None, :]
    return torch.clamp_min(d2, 0.0)


def rbf_cross(x, z, variance, lengthscales):
    """K(X, Z). x: [N, D], z: [M, D] -> [N, M]."""
    return variance * torch.exp(-0.5 * scaled_square_dist(x, z, lengthscales))


def rbf_gram(z, variance, lengthscales):
    """Symmetric Gram matrix K(Z, Z). z: [M, D] -> [M, M]."""
    return rbf_cross(z, z, variance, lengthscales)
