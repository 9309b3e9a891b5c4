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
    # A CPU operand is made contiguous: MKL takes another path for a
    # transposed right operand at 2-4 rows, so a row's bits would depend on
    # the row count. The card keeps the transposed operand and its GEMM.
    zt = zs.T.contiguous() if zs.device.type == "cpu" else zs.T
    d2 = xn[:, None] - 2.0 * torch.matmul(xs, zt) + zn[None, :]
    return torch.clamp_min(d2, 0.0)


def rbf_cross(x, z, variance, lengthscales):
    """K(X, Z). x: [N, D], z: [M, D] -> [N, M]."""
    return variance * torch.exp(-0.5 * scaled_square_dist(x, z, lengthscales))


def rbf_gram(z, variance, lengthscales):
    """Symmetric Gram matrix K(Z, Z). z: [M, D] -> [M, M]."""
    return rbf_cross(z, z, variance, lengthscales)



def rbf_diag(n: int, variance, dtype, device=None):
    """diag(K(X, X)) of ``n`` points: the constant ``variance`` of the RBF
    kernel, on ``device`` (torch's default device if None). -> [n]."""
    return torch.full((n,), variance, dtype=dtype, device=device)
