"""Shared model scaffolding (port of ``cbfssm_tpu/models/base.py``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from cbfssm_tpu_torch.config import as_config
from cbfssm_tpu_torch.ops import gp, transforms
from cbfssm_tpu_torch.ops.distributions import diag_gaussian_logpdf

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class PredictOutput:
    """Free-running / conditioned prediction statistics."""

    pred_mean: Any  # [B, T, dy] mean over particles
    pred_var: Any  # [B, T, dy] variance over particles + observation noise
    internal_mean: Any  # [B, T, dx]
    internal_var: Any  # [B, T, dx]
    mse: Any  # scalar
    sde: Any  # [B, T, dy] standardized error

    def replace(self, **changes) -> "PredictOutput":
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "PredictOutput":
        """A new output with ``fn`` applied to every field."""
        return PredictOutput(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def moments_over_samples(x):
    """Population mean/variance over the particle axis of [B, T, S, D]."""
    mean = torch.mean(x, dim=2)
    var = torch.mean(torch.square(x - mean[:, :, None, :]), dim=2)
    return mean, var


class BaseSSM:
    """Common config handling + loss/prediction helpers.

    ``device`` places parameters, noise draws and computation: the card
    unless the caller asks for ``"cpu"``. The config keys and their
    checks are the JAX package's. Options that belong to the TPU (fused
    multi-epoch dispatch, the hand and parallel adjoints) are accepted
    at their defaults only; with ``adjoint='auto'`` gradients come from
    autograd, as 'auto' resolves to autodiff in the JAX package.
    """

    def __init__(self, config, device="cuda"):
        self.config = as_config(config)
        self.device = torch.device(device)
        if self.config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be 'float32' or 'float64', got {self.config.dtype!r}")
        self.dtype = _DTYPES[self.config.dtype]
        self.np_dtype = np.dtype(self.config.dtype)
        self.dim_u = int(self.config.dim_u)
        self.dim_y = int(self.config.dim_y)
        self.samples = int(self.config.samples)
        self.jitter = self.config.jitter
        if self.config.gp_impl not in ("solve_free", "pallas"):
            raise ValueError(f"unknown gp_impl: {self.config.gp_impl!r}")
        if self.config.adjoint not in ("auto", "autodiff", "hand", "parallel"):
            raise ValueError(
                "adjoint must be 'auto', 'autodiff', 'hand', or "
                f"'parallel', got {self.config.adjoint!r}"
            )
        if self.config.adjoint != "auto":
            raise ValueError(
                f"adjoint={self.config.adjoint!r} is not ported; only the "
                "default 'auto' is accepted"
            )
        if self.config.epochs_per_dispatch != "auto":
            raise ValueError(
                "epochs_per_dispatch (fused multi-epoch dispatch) is not "
                "ported; only the default 'auto' is accepted"
            )
        if not isinstance(self.config.skip_nonfinite_updates, (bool, np.bool_)):
            raise ValueError(
                "skip_nonfinite_updates must be True or False, got "
                f"{self.config.skip_nonfinite_updates!r}"
            )
        if self.config.backward_mode not in ("auto", "blocked", "sequential"):
            raise ValueError(
                "backward_mode must be 'auto', 'blocked', or "
                f"'sequential', got {self.config.backward_mode!r}"
            )
        if int(self.config.scan_unroll) < 1:
            raise ValueError(
                f"scan_unroll must be a positive int, got {self.config.scan_unroll!r}"
            )
        if self.config.gp_matmul_precision not in ("highest", "high", "default"):
            raise ValueError(
                "gp_matmul_precision must be 'highest', 'high', or "
                f"'default', got {self.config.gp_matmul_precision!r}"
            )
        if self.config.gp_matmul_precision == "default":
            raise ValueError(
                "gp_matmul_precision='default' (one bf16 pass on the TPU) is "
                "not ported; 'high' and 'highest' both run IEEE float32"
            )

    def _check_noise_lengths(self, **expected):
        """Validate config noise-vector lengths early with a clear error."""
        for name, want in expected.items():
            value = np.asarray(getattr(self.config, name))
            if value.ndim != 1 or value.shape[0] != want:
                raise ValueError(
                    f"config['{name}'] must be a length-{want} vector for "
                    f"{type(self).__name__}, got shape {value.shape}"
                )

    def _gp_predict(self, cache, xnew):
        """Time-recursion GP predictive, chosen by ``config.gp_impl``:
        'pallas' -> the fused kernel, 'solve_free' -> torch ops."""
        if self.config.gp_impl == "pallas":
            return gp.predict_fast(cache, xnew)
        return gp.predict(cache, xnew)

    # --- parameter helpers --------------------------------------------

    def _noise_unc(self, value) -> torch.Tensor:
        """Unconstrained (inverse-softplus) init for a noise variance."""
        return torch.as_tensor(
            transforms.positive_inverse(np.asarray(value)), dtype=self.dtype, device=self.device
        )

    # --- loss helpers --------------------------------------------------

    def _loglik(self, y_final, y_obs, var_y_obs):
        """[T, B, S, dy] x [T, B, dy] -> per-sequence log-likelihood [B]."""
        ll = diag_gaussian_logpdf(y_obs[:, :, None, :], y_final, var_y_obs)
        return torch.sum(ll, dim=(0, 2))

    def _prediction_stats(self, x_final, y_obs, var_y) -> PredictOutput:
        """x_final: [T, B, S, dx] (time-major), y_obs: [T, B, dy]."""
        dim_y = self.dim_y
        x_bt = x_final.permute(1, 0, 2, 3)
        internal_mean, internal_var = moments_over_samples(x_bt)
        pred_mean = internal_mean[..., :dim_y]
        pred_var = internal_var[..., :dim_y] + var_y[:dim_y]
        y_bt = y_obs.permute(1, 0, 2)
        mse = torch.mean(torch.square(pred_mean - y_bt))
        sde = torch.abs(pred_mean - y_bt) / torch.sqrt(pred_var)
        return PredictOutput(pred_mean, pred_var, internal_mean, internal_var, mse, sde)

    # --- data staging --------------------------------------------------

    def _time_major(self, a):
        """[B, T, D] array or tensor -> [T, B, D] on the model's device
        in the compute dtype."""
        return torch.as_tensor(a, dtype=self.dtype, device=self.device).transpose(0, 1)

    def _shared_eps(self, generator, shape):
        """Per-(time, batch, particle) standard-normal draws shared
        across state dimensions: ``shape + (1,)``, from ``generator`` on
        the model's device."""
        return torch.randn(
            tuple(shape) + (1,), generator=generator, dtype=self.dtype, device=self.device
        )


LOG_2PI_E = math.log(2.0 * math.pi * math.e)
