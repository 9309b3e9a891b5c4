"""Softplus positivity re-parameterization (port of
``cbfssm_tpu/ops/transforms.py``)."""

from __future__ import annotations

import numpy as np
import torch

# Floor added after softplus so constrained values are strictly positive.
_EPS = 1e-10
# Above this threshold softplus is numerically the identity; the inverse
# uses a linearization to avoid overflow in exp.
_LINEAR_THRESHOLD = 35.0


def positive(x_unconstrained: torch.Tensor) -> torch.Tensor:
    """Map an unconstrained tensor to strictly positive values."""
    return torch.logaddexp(x_unconstrained, torch.zeros_like(x_unconstrained)) + _EPS


def positive_inverse(y) -> np.ndarray:
    """Inverse of :func:`positive`, evaluated host-side with numpy.
    Requires y > 1e-10."""
    y = np.asarray(y, dtype=np.float64)
    if np.any(y <= _EPS):
        raise ValueError("positive_inverse requires inputs > 1e-10")
    shifted = y - _EPS
    # softplus^-1(z) = log(exp(z) - 1)
    with np.errstate(over="ignore"):
        inv = np.where(
            shifted > _LINEAR_THRESHOLD,
            shifted,
            np.log(np.expm1(np.where(shifted > _LINEAR_THRESHOLD, 1.0, shifted))),
        )
    return inv
