"""Closed-form Gaussian quantities (port of
``cbfssm_tpu/ops/distributions.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from cbfssm_tpu_torch.ops import linalg

_LOG_2PI = math.log(2.0 * math.pi)


def diag_gaussian_logpdf(x, mean, var, axis=-1):
    """log N(x | mean, diag(var)), summed over ``axis``."""
    ll = -0.5 * (_LOG_2PI + torch.log(var) + torch.square(x - mean) / var)
    return torch.sum(ll, dim=axis)


def kl_diag_gaussians(mean_q, var_q, mean_p, var_p, axis=-1):
    """KL(N(mean_q, diag var_q) || N(mean_p, diag var_p)) over ``axis``."""
    kl = (
        torch.log(var_p) - torch.log(var_q)
        + (var_q + torch.square(mean_q - mean_p)) / var_p - 1.0
    )
    return 0.5 * torch.sum(kl, dim=axis)


def kl_diag_vs_tril(mean_q, var_q, chol_p, kinv_p_diag, kinv_mean):
    """KL( N(mean_q, diag var_q) || N(0, K) ) summed over output dims.

    mean_q, var_q : [M, D]; chol_p : [M, M] lower Cholesky of K;
    kinv_p_diag : [M] diag of K^-1; kinv_mean : [M, D] K^-1 @ mean_q.
    """
    m = mean_q.shape[0]
    logdet_k = linalg.log_det_from_chol(chol_p)
    trace_term = torch.sum(kinv_p_diag[:, None] * var_q, dim=0)
    maha = torch.sum(mean_q * kinv_mean, dim=0)
    logdet_q = torch.sum(torch.log(var_q), dim=0)
    kl = 0.5 * (trace_term + maha - m + logdet_k - logdet_q)
    return torch.sum(kl)


def beta_logpdf(x, alpha, beta):
    """log Beta(x | alpha, beta), elementwise: the Beta priors on
    Voliro's GP noise and lengthscales. When alpha and beta are Python
    or numpy scalars (static config values) the log-normalizer comes
    from ``math.lgamma`` in double precision, as in the JAX package;
    otherwise (tensors) from ``torch.lgamma``."""
    if isinstance(alpha, (int, float, np.number)) and isinstance(beta, (int, float, np.number)):
        a, b = float(alpha), float(beta)
        log_norm = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    else:
        alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
        beta = torch.as_tensor(beta, dtype=x.dtype, device=x.device)
        log_norm = torch.lgamma(alpha) + torch.lgamma(beta) - torch.lgamma(alpha + beta)
    return (alpha - 1.0) * torch.log(x) + (beta - 1.0) * torch.log1p(-x) - log_norm
