"""Shared model scaffolding (port of ``cbfssm_tpu/models/base.py``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from cbfssm_tpu_torch.config import as_config
from cbfssm_tpu_torch.models import recognition
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


def hyper(value):
    """A loss-time hyperparameter of the config (k_factor, an entry of
    loss_factors, ...): a tensor as it is, which is how a sweep passes
    its values (0-d, batched over lanes under ``torch.func.vmap``);
    anything else as a Python float, as before."""
    return value if isinstance(value, torch.Tensor) else float(value)


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
        self._check_precision()

    def _check_precision(self):
        """A float32 model on the card needs IEEE float32 matmuls (the
        config's promise for 'high' and 'highest'): raise while cuBLAS
        may use TF32. Models call it at construction and at every entry
        point, since the flag can change in between."""
        if self.device.type != "cuda" or self.dtype != torch.float32:
            return
        # fp32_precision reflects both the legacy allow_tf32 flag and
        # the newer API (reading allow_tf32 raises once they are mixed)
        if torch.backends.cuda.matmul.fp32_precision == "tf32":
            raise ValueError(
                "torch.backends.cuda.matmul.allow_tf32 is on (also set by "
                "torch.set_float32_matmul_precision('high')): a float32 model on "
                "the GPU runs its matmuls in IEEE float32; set it to False"
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

    def _eps_or_draw(self, eps, generator, shape):
        """``eps`` on the model's device, checked to be ``shape + (1,)``,
        or, when it is None, a draw of that shape from ``generator``."""
        want = tuple(shape) + (1,)
        if eps is None:
            if generator is None:
                raise ValueError("need a generator or ready-made noise")
            return self._shared_eps(generator, shape)
        eps = torch.as_tensor(eps, dtype=self.dtype, device=self.device)
        if tuple(eps.shape) != want:
            raise ValueError(f"eps must be {list(want)}, got {list(eps.shape)}")
        return eps

    # --- fused backlog replay (streaming models) -------------------------

    def filter_replay(self, params, ops, x, u_block, y_block, generator=None, active=None,
                      eps=None):
        """K sequential ``filter_step`` calls: the backlog catch-up of a
        streaming estimator (port of the JAX ``filter_replay``). Generic
        over the subclass's ``filter_step``, so the per-step math is
        shared by construction.

        Args:
          u_block / y_block: ``[B, K, du]`` / ``[B, K, dy]``, batch-major.
          generator / eps: the per-step particle draws, either drawn from
            ``generator`` as ``[K, B, S, 1]`` or given ready-made as
            ``eps`` of that shape (``[K, n, B, S, 1]`` for a model whose
            step takes ``FILTER_DRAWS = n`` draws). (The JAX package draws
            step i from ``fold_in(base_key, t0 + i)``; the tests pass
            those draws.)
          active: optional bool ``[K]`` (shared across the batch) or
            ``[K, B]``; inactive steps HOLD the ensemble (their mean/var
            outputs are placeholders from the discarded transition).

        Returns ``(x_final [B, S, dx], (mean [B, K, dy], var [B, K, dy]))``.
        """
        if not hasattr(self, "filter_step"):
            raise TypeError(
                f"{type(self).__name__} has no filter_step; filter_replay "
                "needs the streaming interface"
            )
        self._check_precision()
        b, s = x.shape[0], x.shape[1]
        u_tm, y_tm = self._time_major(u_block), self._time_major(y_block)
        k_len = u_tm.shape[0]
        if active is None:
            active = torch.ones((k_len,), dtype=torch.bool)
        active = torch.as_tensor(active, device=self.device)
        if tuple(active.shape) not in ((k_len,), (k_len, b)):
            raise ValueError(
                f"active must be [{k_len}] or [{k_len}, {b}], got {tuple(active.shape)}"
            )
        draws = getattr(self, "FILTER_DRAWS", 1)
        eps = self._eps_or_draw(eps, generator, (k_len, b, s) if draws == 1
                                else (k_len, draws, b, s))
        means, vars_ = [], []
        for i in range(k_len):
            x_next, (mean, var) = self.filter_step(params, ops, x, u_tm[i], y_tm[i], eps=eps[i])
            a_bc = active[i] if active.dim() == 1 else active[i][:, None, None]
            x = torch.where(a_bc, x_next, x)
            means.append(mean)
            vars_.append(var)
        return x, (torch.stack(means, dim=1), torch.stack(vars_, dim=1))


LOG_2PI_E = math.log(2.0 * math.pi * math.e)


@dataclasses.dataclass
class RecognitionParams:
    """Parameters of a model with one transition GP and a recognition
    net (CBFSSMHALF, PRSSM)."""

    gp_f: gp.SparseGPParams  # dynamics GP: dim_x + dim_u -> dim_x
    var_x_unc: torch.Tensor  # [dim_x] unconstrained process noise
    var_y_unc: torch.Tensor  # [dim_y] unconstrained observation noise
    recog: dict  # the recognition net's leaves by name ({} for 'output')

    def tensors(self) -> list:
        """The leaves in a fixed order (gp_f's in ``SparseGPParams`` field
        order, var_x_unc, var_y_unc, then the net's in its ``LEAVES``
        order): the optimizer's parameter list and the checkpoint layout."""
        return [*self.gp_f.tensors(), self.var_x_unc, self.var_y_unc, *self.recog.values()]

    def with_tensors(self, tensors) -> "RecognitionParams":
        """Params of this structure (this net's leaves) with the leaves
        ``tensors``, in :meth:`tensors` order."""
        t = list(tensors)
        n = len(gp.SparseGPParams.__dataclass_fields__)
        want = n + 2 + len(self.recog)
        if len(t) != want:
            raise ValueError(f"{type(self).__name__} takes {want} tensors, got {len(t)}")
        return type(self)(gp.SparseGPParams(*t[:n]), t[n], t[n + 1],
                          dict(zip(self.recog, t[n + 2:])))

    def to(self, *args, **kwargs) -> "RecognitionParams":
        """Every leaf through ``Tensor.to(*args, **kwargs)``."""
        return self.with_tensors([t.to(*args, **kwargs) for t in self.tensors()])

    def detach(self) -> "RecognitionParams":
        """The same values, cut from autograd."""
        return self.with_tensors([t.detach() for t in self.tensors()])


class RecognitionSSM(BaseSSM):
    """A model whose x_0 comes from a recognition net over the first
    ``recog_len`` steps and whose only recursion is a particle rollout
    through one transition GP (CBFSSMHALF, PRSSM). Subclasses set
    ``PARAMS`` and pass the recognition kind."""

    PARAMS = RecognitionParams

    def __init__(self, config, device, recog_kind: str):
        super().__init__(config, device)
        self.dim_x = int(self.config.dim_x)
        self._check_noise_lengths(var_x=self.dim_x, var_y=self.dim_y)
        if self.dim_x < self.dim_y:
            raise ValueError(
                f"{type(self).__name__} needs dim_x >= dim_y, got "
                f"dim_x={self.dim_x} < dim_y={self.dim_y}"
            )
        self.recog_kind = recog_kind
        self.recog_module = recognition.make_recognition(
            recog_kind, self.dim_u + self.dim_y, self.dim_x, int(self.config.recog_len),
            self.dtype,
        )

    def init(self, generator: torch.Generator):
        """Random parameters: gp_f, then the recognition net, from
        ``generator`` (which must live on the model's device)."""
        cfg = self.config
        gp_f = gp.init_sparse_gp(
            generator, self.dim_x + self.dim_u, self.dim_x, num_points=cfg.ind_pnt_num,
            gp_var=cfg.gp_var, gp_len=cfg.gp_len, zeta_mean=cfg.zeta_mean,
            zeta_pos=cfg.zeta_pos, zeta_var=cfg.zeta_var, dtype=self.dtype, device=self.device,
        )
        return self.PARAMS(
            gp_f=gp_f,
            var_x_unc=self._noise_unc(cfg.var_x),
            var_y_unc=self._noise_unc(cfg.var_y),
            recog=recognition.init_leaves(self.recog_module, generator, self.dtype, self.device),
        )

    def draw_noise(self, generator: torch.Generator, t_len: int, b: int) -> torch.Tensor:
        """The rollout's draws ``[T-1, B, S, 1]``, in the JAX package's
        shape (the JAX models draw them straight from the loss key)."""
        return self._shared_eps(generator, (t_len - 1, b, self.samples))

    def _initial_state(self, params, u, y):
        """x_0 [B, S, dim_x], the same for every particle, from the
        recognition net over the first recog_len steps (or the first
        observation, zero-padded, for 'output')."""
        kw = dict(dtype=self.dtype, device=self.device)
        y = torch.as_tensor(y, **kw)
        if self.recog_module is None:
            x0 = recognition.output_recognition(y, self.dim_x)
        else:
            uy = torch.cat((torch.as_tensor(u, **kw), y), dim=-1)[:, : self.config.recog_len]
            x0 = recognition.apply(self.recog_module, params.recog, uy)
        return x0[:, None, :].expand(x0.shape[0], self.samples, self.dim_x)

    def _rollout_inputs(self, params, u, y, generator, noise):
        """The rollout's set-up: (var_x, var_y, cache_f, u_tm, y_tm, eps)."""
        self._check_precision()
        u_tm, y_tm = self._time_major(u), self._time_major(y)
        t_len, b = u_tm.shape[0], u_tm.shape[1]
        eps = self._eps_or_draw(noise, generator, (t_len - 1, b, self.samples))
        return (transforms.positive(params.var_x_unc), transforms.positive(params.var_y_unc),
                gp.precompute(params.gp_f, self.jitter), u_tm, y_tm, eps)

    def _weights(self, weights, b):
        kw = dict(dtype=self.dtype, device=self.device)
        return torch.ones(b, **kw) if weights is None else torch.as_tensor(weights, **kw)
