"""PR-SSM baseline, Doerr et al. 2018 (port of
``cbfssm_tpu/models/prssm.py``): one sparse-GP transition, recognition
'output' / 'conv' / 'rnn', a pure prior particle rollout (no
conditioning on future observations), and ELBO = lambda_1 * loglik -
KL(zeta), faithfully NOT divided by the particle count.

Each step makes one GP prediction (``BaseSSM._gp_predict``), the fused
CUDA kernel under ``gp_impl='pallas'``. The rollout draws are taken
ready-made as ``noise=`` (``[T-1, B, S, 1]``) or drawn from a
``torch.Generator``.
"""

from __future__ import annotations

import torch

from cbfssm_tpu_torch.config import as_config
from cbfssm_tpu_torch.models.base import PredictOutput, RecognitionParams, RecognitionSSM, hyper
from cbfssm_tpu_torch.ops import gp, transforms


class PRSSMParams(RecognitionParams):
    """gp_f, var_x_unc [dim_x], var_y_unc [dim_y], recog (the net's leaves)."""


class PRSSM(RecognitionSSM):
    # The ELBO is not divided by the particle count (prssm.py:96-97);
    # particle-parallel recombination must not normalize either.
    PARTICLE_NORMALIZED = False
    # loss-time fields this model reads: a pure prior rollout, so no k_factor
    SWEEPABLE_HYPERS = frozenset({"loss_factors"})
    # parameter-only aux entries
    REPLICATED_AUX = frozenset({"kl_z", "global_term", "particle_divisor"})
    PARAMS = PRSSMParams

    def __init__(self, config, device="cuda"):
        super().__init__(config, device, as_config(config).recog_model)

    def var_dict(self, params: PRSSMParams) -> dict:
        """Named hyper/variational parameters (the reference var_dump)."""
        return {
            "process noise": transforms.positive(params.var_x_unc),
            "observation noise": transforms.positive(params.var_y_unc),
            "kernel lengthscales": params.gp_f.kern_len,
            "kernel variance": params.gp_f.kern_var,
            "IP pos": params.gp_f.z,
            "IP mean": params.gp_f.mean,
            "IP var": params.gp_f.var,
        }

    def _rollout(self, params: PRSSMParams, u, y, generator=None, noise=None):
        var_x, var_y, cache_f, u_tm, _, eps = self._rollout_inputs(params, u, y, generator, noise)
        t_len, b = u_tm.shape[0], u_tm.shape[1]
        s, dx, du = self.samples, self.dim_x, self.dim_u
        x = self._initial_state(params, u, y)
        xs = [x]
        for t in range(t_len - 1):
            u_bs = u_tm[t][:, None, :].expand(b, s, du)
            gp_in = torch.cat((x, u_bs), dim=-1).reshape(b * s, -1)
            fmean, fvar = self._gp_predict(cache_f, gp_in)
            fmean = fmean.reshape(b, s, dx) + x
            fvar = fvar.reshape(b, s, dx) + var_x
            x = fmean + eps[t] * torch.sqrt(fvar)
            xs.append(x)
        return torch.stack(xs), (var_y, cache_f, self._time_major(y))

    def loss(self, params: PRSSMParams, u, y, generator=None, condition: bool = True,
             weights=None, noise=None):
        """ELBO = lambda_1 * loglik - KL(zeta) (prssm.py:96-97). Returns
        (loss, aux). ``condition`` is accepted for interface parity and
        has no effect: PR-SSM never conditions on future observations."""
        del condition
        x_final, (var_y, cache_f, y_tm) = self._rollout(params, u, y, generator, noise)
        loglik = self._loglik(x_final[..., : self.dim_y], y_tm, var_y[: self.dim_y])
        weights = self._weights(weights, y_tm.shape[1])
        lam1 = hyper(self.config.loss_factors[0])
        kl_z = gp.prior_kl(params.gp_f, cache_f)
        particle_sum = lam1 * torch.dot(loglik, weights)
        global_term = -kl_z
        elbo = particle_sum + global_term  # not divided by the particle count
        aux = {
            "loglik": torch.dot(loglik, weights),
            "kl_z": kl_z,
            "particle_sum": particle_sum,
            "particle_divisor": torch.full((), 1.0, dtype=self.dtype, device=self.device),
            "global_term": global_term,
        }
        return -elbo, aux

    def predict(self, params: PRSSMParams, u, y, generator=None, condition: bool = False,
                noise=None) -> PredictOutput:
        """Free-running prediction statistics (``condition`` has no effect)."""
        del condition
        x_final, (var_y, _, y_tm) = self._rollout(params, u, y, generator, noise)
        return self._prediction_stats(x_final, y_tm, var_y)
