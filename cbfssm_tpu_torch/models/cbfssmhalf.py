"""CBFSSM-half (port of ``cbfssm_tpu/models/cbfssmhalf.py``): the
forward-only variant for stable systems. There is no backward
recognition GP: x_0 comes from a recognition net ('rnn', a GRU(16), by
default, or 'output'); the Kalman-style conditioning update acts only on
the observed dims (zero-padded for the hidden ones); the ELBO has no
entropy term.

Each step makes one GP prediction (``BaseSSM._gp_predict``), the fused
CUDA kernel under ``gp_impl='pallas'``. As in the port's CBFSSM, the
rollout draws are taken ready-made as ``noise=`` (``[T-1, B, S, 1]``,
:meth:`draw_noise`) or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cbfssm_tpu_torch.config import as_config
from cbfssm_tpu_torch.models import segmentation
from cbfssm_tpu_torch.models.base import PredictOutput, RecognitionParams, RecognitionSSM, hyper
from cbfssm_tpu_torch.ops import gp, transforms
from cbfssm_tpu_torch.ops.distributions import kl_diag_gaussians


class CBFSSMHALFParams(RecognitionParams):
    """gp_f, var_x_unc [dim_x], var_y_unc [dim_y], recog (the net's leaves)."""


class CBFSSMHALF(RecognitionSSM):
    # loss-time fields this model reads; only loss_factors[0] enters the
    # ELBO (no entropy term)
    SWEEPABLE_HYPERS = frozenset({"loss_factors", "k_factor"})
    # parameter-only aux entries
    REPLICATED_AUX = frozenset({"kl_z_f", "global_term", "particle_divisor"})
    PARAMS = CBFSSMHALFParams

    def __init__(self, config, device="cuda"):
        kind = as_config(config).recog_model or "rnn"
        if kind == "conv":
            raise ValueError("CBFSSMHALF supports 'output' and 'rnn' recognition")
        super().__init__(config, device, kind)

    def var_dict(self, params: CBFSSMHALFParams) -> dict:
        """Named hyper/variational parameters (the reference var_dump)."""
        return {
            "process noise": transforms.positive(params.var_x_unc),
            "observation noise": transforms.positive(params.var_y_unc),
            "kernel lengthscales f": params.gp_f.kern_len,
            "kernel variance f": params.gp_f.kern_var,
            "IP pos f": params.gp_f.z,
            "IP mean f": params.gp_f.mean,
            "IP var f": params.gp_f.var,
        }

    def _transition(self, cache_f, var_x, var_y, b, s):
        """The conditioned transition, shared by the training rollout and
        the streaming entry points (filter_step / forecast).

        ``step(x [B,S,dx], (u_t [B,du], y_next [B,dy], eps_t [B,S,1],
        cond_t bool)) -> (x_next, (x_next, kl_t [B]))``. ``cond_t`` is a
        Python bool: an unconditioned step takes the prior transition
        and a KL of zero, as the JAX step's ``jnp.where`` selects."""
        dx, dy, du = self.dim_x, self.dim_y, self.dim_u
        k_factor = hyper(self.config.k_factor)

        def pad_h(a):
            return F.pad(a, (0, dx - dy))

        def step(x, inp):
            u_t, y_next, eps_t, cond_t = inp
            u_bs = u_t[:, None, :].expand(b, s, du)
            gp_in = torch.cat((x, u_bs), dim=-1).reshape(b * s, -1)
            fmean, fvar = self._gp_predict(cache_f, gp_in)
            fmean = fmean.reshape(b, s, dx) + x
            fvar = fvar.reshape(b, s, dx) + var_x
            if not cond_t:
                x_next = fmean + eps_t * torch.sqrt(fvar)
                return x_next, (x_next, torch.zeros(b, dtype=x.dtype, device=x.device))
            fvar_o = fvar[..., :dy]
            var_y_t = var_y + (k_factor - 1.0) * fvar_o
            gain = fvar_o / (var_y_t + fvar_o)
            y_bs = y_next[:, None, :].expand(b, s, dy)
            mu = fmean + pad_h(gain * (y_bs - fmean[..., :dy]))
            sig = torch.square(1.0 - pad_h(gain)) * fvar + pad_h(torch.square(gain) * var_y_t)
            x_next = mu + eps_t * torch.sqrt(sig)
            kl_t = kl_diag_gaussians(mu, sig, fmean, fvar, axis=(1, 2))
            return x_next, (x_next, kl_t)

        return step

    def _rollout(self, params: CBFSSMHALFParams, u, y, generator=None, condition: bool = True,
                 noise=None):
        var_x, var_y, cache_f, u_tm, y_tm, eps = self._rollout_inputs(
            params, u, y, generator, noise
        )
        t_len, b = u_tm.shape[0], u_tm.shape[1]
        cond = segmentation.forward_condition_mask(t_len, self.config.recog_len)
        step = self._transition(cache_f, var_x, var_y, b, self.samples)
        x = self._initial_state(params, u, y)
        xs, kls = [x], []
        for t in range(t_len - 1):
            x, (_, kl_t) = step(x, (u_tm[t], y_tm[t + 1], eps[t], bool(condition or cond[t])))
            xs.append(x)
            kls.append(kl_t)
        kl_x = (torch.sum(torch.stack(kls), dim=0) if kls
                else torch.zeros(b, dtype=self.dtype, device=self.device))
        return torch.stack(xs), kl_x, (var_y, cache_f, y_tm)

    def loss(self, params: CBFSSMHALFParams, u, y, generator=None, condition: bool = True,
             weights=None, noise=None):
        """ELBO = (loglik - kl_x) * lambda_1 / samples - KL(zeta_f)
        (cbfssmhalf.py:173-195; no entropy term). Returns (loss, aux);
        differentiable in ``params``."""
        x_final, kl_x, (var_y, cache_f, y_tm) = self._rollout(
            params, u, y, generator, condition, noise
        )
        loglik = self._loglik(x_final[..., : self.dim_y], y_tm, var_y[: self.dim_y])
        weights = self._weights(weights, y_tm.shape[1])
        lam1 = hyper(self.config.loss_factors[0])
        kl_zf = gp.prior_kl(params.gp_f, cache_f)
        particle_sum = lam1 * torch.dot(loglik - kl_x, weights)
        global_term = -kl_zf
        elbo = particle_sum / self.samples + global_term
        aux = {
            "loglik": torch.dot(loglik, weights),
            "kl_x": torch.dot(kl_x, weights),
            "kl_z_f": kl_zf,
            "particle_sum": particle_sum,
            "particle_divisor": torch.full((), float(self.samples), dtype=self.dtype,
                                             device=self.device),
            "global_term": global_term,
        }
        return -elbo, aux

    def predict(self, params: CBFSSMHALFParams, u, y, generator=None, condition: bool = False,
                noise=None) -> PredictOutput:
        """Prediction statistics; with ``condition=False`` the rollout is
        free-running after the recognition prefix."""
        x_final, _, (var_y, _, y_tm) = self._rollout(params, u, y, generator, condition, noise)
        return self._prediction_stats(x_final, y_tm, var_y)

    # --- streaming/online filtering --------------------------------------

    def filter_ops(self, params: CBFSSMHALFParams):
        """(cache_f, var_x, var_y): the loop-invariant operators a
        streaming consumer precomputes once per parameter set."""
        self._check_precision()
        return (gp.precompute(params.gp_f, self.jitter),
                transforms.positive(params.var_x_unc), transforms.positive(params.var_y_unc))

    def filter_init(self, params: CBFSSMHALFParams, u_prefix, y_prefix):
        """Particle ensemble x_0 [B, S, dim_x] from a warmup window via
        the recognition net (the initial state training uses)."""
        self._check_precision()
        return self._initial_state(params, u_prefix, y_prefix)

    def filter_step(self, params, ops, x, u_prev, y_new, generator=None, eps=None):
        """One online conditioned transition of the particle ensemble,
        with the training rollout's step body: the applied control
        ``u_prev`` [B, du] and the arriving observation ``y_new``
        [B, dy]. ``eps`` ([B, S, 1]) overrides the draw from
        ``generator``. Returns (x_next [B, S, dx], (mean [B, dy], var
        [B, dy])): the filtered observation-space moments (particle
        moments plus observation noise)."""
        self._check_precision()
        cache_f, var_x, var_y = ops
        b, s = x.shape[0], x.shape[1]
        eps = self._eps_or_draw(eps, generator, (b, s))
        kw = dict(dtype=self.dtype, device=self.device)
        step = self._transition(cache_f, var_x, var_y, b, s)
        x_next, _ = step(x, (torch.as_tensor(u_prev, **kw), torch.as_tensor(y_new, **kw), eps,
                             True))
        y_part = x_next[..., : self.dim_y]
        mean = torch.mean(y_part, dim=1)
        var = torch.mean(torch.square(y_part - mean[:, None, :]), dim=1) + var_y
        return x_next, (mean, var)

    def forecast(self, params, ops, x, u_future, generator=None, eps=None):
        """Free-run rollout from the current ensemble (no conditioning).
        u_future: [B, H, du] -> (mean [B, H, dy], var [B, H, dy]); the
        caller's ensemble is not advanced. ``eps`` ([H, B, S, 1])
        overrides the draws from ``generator``."""
        self._check_precision()
        cache_f, var_x, var_y = ops
        b, s = x.shape[0], x.shape[1]
        u_tm = self._time_major(u_future)
        h = u_tm.shape[0]
        eps = self._eps_or_draw(eps, generator, (h, b, s))
        step = self._transition(cache_f, var_x, var_y, b, s)
        path = []
        for t in range(h):
            x, _ = step(x, (u_tm[t], None, eps[t], False))
            path.append(x)
        y_part = torch.stack(path)[..., : self.dim_y]  # [H, B, S, dy]
        mean = torch.mean(y_part, dim=2)
        var = torch.mean(torch.square(y_part - mean[:, :, None, :]), dim=2) + var_y
        return mean.transpose(0, 1), var.transpose(0, 1)

    # filter_replay, the K-step backlog catch-up, is BaseSSM's: its loop
    # body is this class's filter_step.
