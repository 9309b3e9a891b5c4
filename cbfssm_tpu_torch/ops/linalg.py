"""Jittered Cholesky and derived operators (port of
``cbfssm_tpu/ops/linalg.py``).

The factorization always runs in float64 and is cast back, which is
what the JAX package does with x64 enabled (the reference's
``cast_cholesky``). The M x M factorization and inverse stay on
``torch.linalg``: they run once per call, outside the time recursion.
"""

from __future__ import annotations

import torch


def default_jitter(dtype) -> float:
    """1e-8 in float64 like the reference; 1e-6 in float32."""
    return 1e-8 if dtype == torch.float64 else 1e-6


def jittered_cholesky(mat: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """Lower Cholesky factor of ``mat + jitter * I`` ([..., M, M])."""
    dtype = mat.dtype
    if jitter is None:
        jitter = default_jitter(dtype)
    work = mat.to(torch.float64)
    eye = torch.eye(work.shape[-1], dtype=work.dtype, device=work.device)
    return torch.linalg.cholesky(work + jitter * eye).to(dtype)


def cholesky_inverse(chol: torch.Tensor) -> torch.Tensor:
    """Explicit ``K^-1`` from a lower Cholesky factor (K = L L^T);
    accepts a leading batch axis ([..., M, M])."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device).expand(chol.shape)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.matmul(linv.transpose(-1, -2), linv)


def log_det_from_chol(chol: torch.Tensor) -> torch.Tensor:
    """log |K| from its lower Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
