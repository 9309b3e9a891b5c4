"""CBF-SSM: conditional backward/forward state-space model (port of
``cbfssm_tpu/models/cbfssm.py``: the differentiable loss and predict).

The recognition (backward) pass runs both segment phases of the
reference together on a leading run axis, in the reference-shaped
sequential schedule or the block-parallel one (depth 2*recog_len). The
forward pass is the conditioned particle rollout. Each step makes one
GP prediction (``BaseSSM._gp_predict``), which is the fused CUDA kernel
under ``gp_impl='pallas'``. Gradients of :meth:`CBFSSM.loss` come from
autograd through the Python loops; under ``gp_impl='pallas'`` each step's
predict contributes the analytic backward of
:class:`cbfssm_tpu_torch.ops.fused_predict.FusedPredict`. With
``adjoint='hand'`` (``gp_impl='solve_free'``) the forward rollout and the
blocked recognition are the hand-scheduled Functions of
:mod:`cbfssm_tpu_torch.models.adjoint`; the sequential recognition
keeps autograd, as in the JAX package.

Random draws: the JAX package draws its noise inside the rollout from a
key. Here :meth:`CBFSSM.draw_noise` draws the same arrays, in the same
shapes, from a ``torch.Generator``; ``_rollout``, ``loss`` and
``predict`` also take them ready-made as ``noise=`` (a
:class:`RolloutNoise`), which is how the tests feed both packages the
same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cbfssm_tpu_torch.models import adjoint, segmentation
from cbfssm_tpu_torch.models.base import LOG_2PI_E, BaseSSM, PredictOutput, hyper, noise_tensors
from cbfssm_tpu_torch.ops import gp, transforms
from cbfssm_tpu_torch.utils.transfer import constant


@dataclass
class CBFSSMParams:
    gp_f: gp.SparseGPParams  # forward dynamics GP: dim_x + dim_u -> dim_x
    gp_b: gp.SparseGPParams  # backward recognition GP: dim_x + dim_u -> dim_x - dim_y
    var_x_unc: torch.Tensor  # [dim_x] unconstrained process noise
    var_y_unc: torch.Tensor  # [dim_x] unconstrained observation noise

    def to(self, *args, **kwargs) -> "CBFSSMParams":
        """Every leaf through ``Tensor.to(*args, **kwargs)``."""
        return self.with_tensors([t.to(*args, **kwargs) for t in self.tensors()])

    def tensors(self) -> list:
        """The leaves in a fixed order (gp_f's, gp_b's in
        ``SparseGPParams`` field order, then var_x_unc, var_y_unc): the
        optimizer's parameter list and the checkpoint layout."""
        return [*self.gp_f.tensors(), *self.gp_b.tensors(), self.var_x_unc, self.var_y_unc]

    @staticmethod
    def from_tensors(tensors) -> "CBFSSMParams":
        """Inverse of :meth:`tensors`."""
        t = list(tensors)
        n = len(gp.SparseGPParams.__dataclass_fields__)
        if len(t) != 2 * n + 2:
            raise ValueError(f"CBFSSMParams takes {2 * n + 2} tensors, got {len(t)}")
        return CBFSSMParams(gp.SparseGPParams(*t[:n]), gp.SparseGPParams(*t[n:2 * n]),
                            t[2 * n], t[2 * n + 1])

    def with_tensors(self, tensors) -> "CBFSSMParams":
        """Params of this structure with the leaves ``tensors`` (in
        :meth:`tensors` order): how the trainer and the outputs rebuild
        any model's params."""
        return CBFSSMParams.from_tensors(tensors)

    def detach(self) -> "CBFSSMParams":
        """The same values, cut from autograd."""
        return self.with_tensors([t.detach() for t in self.tensors()])


@dataclass
class RolloutNoise:
    """The standard-normal draws of one rollout, shared across state
    dimensions (trailing axis 1). ``t_b`` is ``t_ext`` of
    :func:`segmentation.blocked_layout` for the blocked schedule, T for
    the sequential one."""

    backward_noise: torch.Tensor  # [t_b, 2, B, S, 1] resample draws
    backward_eps: torch.Tensor  # [t_b, 2, B, S, 1] transition draws
    forward_eps: torch.Tensor  # [T-1, B, S, 1]

    BATCH_AXES = (2, 2, 1)  # each field's batch axis (parallel.noise_rows)


class CBFSSM(BaseSSM):
    # loss-time fields this model reads (the fields a sweep may vary)
    SWEEPABLE_HYPERS = frozenset({"loss_factors", "k_factor"})
    SUPPORTED_ADJOINTS = frozenset({"auto", "autodiff", "hand"})
    # parameter-only aux entries (never summed over a particle mesh)
    REPLICATED_AUX = frozenset({"kl_z_f", "kl_z_b", "global_term", "particle_divisor"})

    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        self.dim_x = int(self.config.dim_x)
        self.dim_h = self.dim_x - self.dim_y  # unobserved latent dims
        if self.dim_h < 0:
            raise ValueError("dim_x must be >= dim_y")
        self._check_noise_lengths(var_x=self.dim_x, var_y=self.dim_x)

    # --- parameters ----------------------------------------------------

    def init(self, generator: torch.Generator) -> CBFSSMParams:
        """Random parameters: gp_f then gp_b from ``generator`` (which
        must live on the model's device)."""
        cfg = self.config
        gp_kwargs = dict(
            num_points=cfg.ind_pnt_num, gp_var=cfg.gp_var, gp_len=cfg.gp_len,
            zeta_mean=cfg.zeta_mean, zeta_pos=cfg.zeta_pos, zeta_var=cfg.zeta_var,
            dtype=self.dtype, device=self.device,
        )
        d_in = self.dim_x + self.dim_u
        return CBFSSMParams(
            gp_f=gp.init_sparse_gp(generator, d_in, self.dim_x, **gp_kwargs),
            gp_b=gp.init_sparse_gp(generator, d_in, self.dim_h, **gp_kwargs),
            var_x_unc=self._noise_unc(cfg.var_x),
            var_y_unc=self._noise_unc(cfg.var_y),
        )

    def var_dict(self, params: CBFSSMParams) -> dict:
        """Named hyper/variational parameters (the reference var_dump)."""
        return {
            "process noise": transforms.positive(params.var_x_unc),
            "observation noise": transforms.positive(params.var_y_unc),
            "kernel lengthscales f": params.gp_f.kern_len,
            "kernel variance f": params.gp_f.kern_var,
            "IP pos f": params.gp_f.z,
            "IP mean f": params.gp_f.mean,
            "IP var f": params.gp_f.var,
            "kernel lengthscales b": params.gp_b.kern_len,
            "kernel variance b": params.gp_b.kern_var,
            "IP pos b": params.gp_b.z,
            "IP mean b": params.gp_b.mean,
            "IP var b": params.gp_b.var,
        }

    # --- random draws --------------------------------------------------

    def backward_schedule(self, t_len: int) -> str:
        """'blocked' or 'sequential' for a sequence length ('auto' picks
        blocked when it shortens the recursion)."""
        mode = self.config.backward_mode
        if mode == "auto":
            blocked = t_len > 2 * self.config.recog_len and self.dim_h > 0
            mode = "blocked" if blocked else "sequential"
        return mode

    def draw_noise(self, generator: torch.Generator, t_len: int, b: int,
                   out: RolloutNoise | None = None) -> RolloutNoise:
        """The rollout's draws, in the JAX package's shapes and order
        (recognition resample, recognition transition, forward); with
        ``out`` (draws of these shapes) written into its tensors."""
        s = self.samples
        t_b = t_len
        if self.backward_schedule(t_len) == "blocked":
            t_b = segmentation.blocked_layout(t_len, self.config.recog_len)[0]
        outs = (None,) * 3 if out is None else noise_tensors(out)
        return RolloutNoise(
            backward_noise=self._shared_eps(generator, (t_b, 2, b, s), outs[0]),
            backward_eps=self._shared_eps(generator, (t_b, 2, b, s), outs[1]),
            forward_eps=self._shared_eps(generator, (t_len - 1, b, s), outs[2]),
        )

    # --- backward (recognition) pass ------------------------------------

    def _backward(self, cache_b, var_x, u_tm, y_tm, noise, eps):
        """u_tm: [T, B, du], y_tm: [T, B, dy] ->
        (y_tilde [T, B, S, dx], entropy [B])."""
        if self.backward_schedule(u_tm.shape[0]) == "blocked":
            return self._backward_blocked(cache_b, var_x, u_tm, y_tm, noise, eps)
        return self._backward_sequential(cache_b, var_x, u_tm, y_tm, noise, eps)

    def _backward_sequential(self, cache_b, var_x, u_tm, y_tm, noise, eps):
        t_len, b = u_tm.shape[0], u_tm.shape[1]
        s, dh, duy = self.samples, self.dim_h, self.dim_u + self.dim_y
        recog_len = self.config.recog_len
        resample_np, write0_np = segmentation.backward_masks(t_len, recog_len)
        resample = constant(("cbfssm.resample", t_len, recog_len), lambda: resample_np, self.device)
        var_x_h = var_x[:dh]

        h = torch.zeros((2, b, s, dh), dtype=self.dtype, device=self.device)
        y2 = [None] * t_len
        ent = [None] * t_len
        for t in range(t_len - 1, -1, -1):
            h_in = torch.where(resample[t][:, None, None, None], noise[t], h)
            uy = torch.cat((u_tm[t], y_tm[t]), dim=-1)[None, :, None, :].expand(2, b, s, duy)
            gp_in = torch.cat((h_in, uy), dim=-1)  # [2, B, S, dh+duy]
            fmean, fvar = gp.predict_rows(self._gp_predict, cache_b, gp_in, 1)
            fmean = fmean + h_in  # residual transition
            fvar = fvar + var_x_h
            h = fmean + eps[t] * torch.sqrt(fvar)
            run = 0 if write0_np[t] else 1  # the run that writes time t
            y2[t] = h[run]
            ent[t] = 0.5 * torch.sum(LOG_2PI_E + torch.log(fvar[run]), dim=(1, 2))
        entropy = torch.sum(torch.stack(ent), dim=0)
        y_obs = y_tm[:, :, None, :].expand(t_len, b, s, self.dim_y)
        return torch.cat((y_obs, torch.stack(y2)), dim=-1), entropy

    def _backward_blocked(self, cache_b, var_x, u_tm, y_tm, noise, eps):
        """Block-parallel recognition: all 2L-length segments of both
        runs advance together (each begins with a fresh resample; the
        t = T-1 entry state is the zero init, forced by a reset mask).
        Depth 2L instead of T; the GP batch per step is
        2 * n_blocks * B * S rows. ``noise``/``eps`` are indexed by each
        run's shifted time t'' = t + shift_r."""
        t_len, b = u_tm.shape[0], u_tm.shape[1]
        s, dh = self.samples, self.dim_h
        recog_len = self.config.recog_len
        two_l = 2 * recog_len
        t_ext, n_blocks, shifts = segmentation.blocked_layout(t_len, recog_len)

        def shift_stack(a):
            """[T, ...] -> [2, t_ext, ...]: run r's view, zero-padded by
            its shift at the bottom and to t_ext at the top (built by
            concatenation, not written in place, so that it runs under
            torch.func.vmap)."""
            rest = tuple(a.shape[1:])

            def zeros(k):
                return torch.zeros((k,) + rest, dtype=a.dtype, device=a.device)

            return torch.stack([torch.cat((zeros(s_r), a, zeros(t_ext - s_r - t_len)))
                                for s_r in shifts])

        def to_steps(a, lead_run_axis):
            """[2, t_ext, ...] (or [t_ext, 2, ...]) -> [two_l, 2, K, ...]
            with the step axis descending in t' (recursion order)."""
            if not lead_run_axis:
                a = a.movedim(1, 0)
            a = a.reshape((2, n_blocks, two_l) + tuple(a.shape[2:]))
            return a.movedim(2, 0).flip(0)

        # reset-to-zero positions: run r enters absolute t = T-1 (shifted
        # t'' = T-1+s_r) with the zero initial hidden state
        zmask_np = np.arange(t_ext)[None, :] == np.asarray(
            [t_len - 1 + s_r for s_r in shifts]
        )[:, None]
        zmask = constant(("cbfssm.zmask", t_len, recog_len), lambda: zmask_np, self.device)

        z_st = to_steps(zmask, True)
        u_st = to_steps(shift_stack(u_tm), True)
        y_st = to_steps(shift_stack(y_tm), True)
        noise_st = to_steps(noise, False)
        eps_st = to_steps(eps, False)

        h = torch.zeros((2, n_blocks, b, s, dh), dtype=self.dtype, device=self.device)
        resample = [i == 0 for i in range(two_l)]  # at the block top
        if self._hand_adjoint:
            outs, ents = adjoint.backward_scan(resample, cache_b, var_x[:dh], h, u_st, y_st,
                                               z_st, noise_st, eps_st)
        else:
            step = adjoint.backward_step(
                cache_b, var_x[:dh], (2, n_blocks, b, s, dh, self.dim_u + self.dim_y),
                self._gp_predict,
            )
            outs, ents = [], []
            for i in range(two_l):
                h, (out, ent_t) = step(
                    h, (u_st[i], y_st[i], z_st[i], noise_st[i], eps_st[i], resample[i])
                )
                outs.append(out)
                ents.append(ent_t)
            outs, ents = torch.stack(outs), torch.stack(ents)
        # [two_l, 2, K, ...] (descending t') -> [2, t_ext, ...]
        outs = outs.flip(0).movedim(0, 2).reshape((2, t_ext, b, s, dh))
        ents = ents.flip(0).movedim(0, 2).reshape((2, t_ext, b))

        # un-shift each run and select the writing run per absolute t
        _, write0_np = segmentation.backward_masks(t_len, recog_len)
        write0 = constant(("cbfssm.write0", t_len, recog_len), lambda: write0_np, self.device)
        y2_runs = [outs[r, s_r:s_r + t_len] for r, s_r in enumerate(shifts)]
        ent_runs = [ents[r, s_r:s_r + t_len] for r, s_r in enumerate(shifts)]
        y2 = torch.where(write0[:, None, None, None], y2_runs[0], y2_runs[1])
        entropy = torch.sum(torch.where(write0[:, None], ent_runs[0], ent_runs[1]), dim=0)

        y_obs = y_tm[:, :, None, :].expand(t_len, b, s, self.dim_y)
        return torch.cat((y_obs, y2), dim=-1), entropy

    # --- forward (generative) pass --------------------------------------

    def _forward(self, cache_f, var_x, var_y, y_tilde, u_tm, eps, condition: bool):
        """Conditioned particle rollout. y_tilde: [T, B, S, dx],
        u_tm: [T, B, du] -> (x_final [T, B, S, dx], kl_x [B])."""
        t_len, b = u_tm.shape[0], u_tm.shape[1]
        cond_mask = segmentation.forward_condition_mask(t_len, self.config.recog_len)
        cond = [bool(condition or cond_mask[t]) for t in range(t_len - 1)]
        k_factor = hyper(self.config.k_factor)
        x = y_tilde[0]
        if self._hand_adjoint and t_len > 1:
            x_rest, kl_steps = adjoint.forward_scan(
                cond, cache_f, var_x, var_y, k_factor, x, u_tm[:-1], y_tilde[1:], eps)
            return torch.cat((x[None], x_rest)), torch.sum(kl_steps, dim=0)
        step = adjoint.forward_step(
            cache_f, var_x, var_y, k_factor, (b, self.samples, self.dim_x, self.dim_u),
            self._gp_predict,
        )
        xs, kls = [x], []
        for t in range(t_len - 1):
            x, (_, kl_t) = step(x, (u_tm[t], y_tilde[t + 1], eps[t], cond[t]))
            xs.append(x)
            kls.append(kl_t)
        kl_x = (
            torch.sum(torch.stack(kls), dim=0)
            if kls else torch.zeros(b, dtype=self.dtype, device=self.device)
        )
        return torch.stack(xs), kl_x

    # --- ELBO ----------------------------------------------------------

    def _rollout(self, params: CBFSSMParams, u, y, generator=None,
                 condition: bool = True, noise: RolloutNoise | None = None):
        self._check_precision()
        var_x = transforms.positive(params.var_x_unc)
        var_y = transforms.positive(params.var_y_unc)
        cache_f, cache_b = gp.precompute_pair(params.gp_f, params.gp_b, self.jitter)
        u_tm, y_tm = self._time_major(u), self._time_major(y)
        if noise is None:
            if generator is None:
                raise ValueError("need a generator or ready-made noise")
            noise = self.draw_noise(generator, u_tm.shape[0], u_tm.shape[1])
        y_tilde, entropy = self._backward(
            cache_b, var_x, u_tm, y_tm, noise.backward_noise, noise.backward_eps
        )
        x_final, kl_x = self._forward(
            cache_f, var_x, var_y, y_tilde, u_tm, noise.forward_eps, condition
        )
        return x_final, kl_x, entropy, (var_x, var_y, cache_f, cache_b, y_tm)

    def loss(self, params: CBFSSMParams, u, y, generator=None, condition: bool = True,
             weights=None, noise: RolloutNoise | None = None):
        """Negative ELBO (cbfssm.py:239-262): per-sequence terms are
        weighted (pad masking) and summed; inducing-point KLs are global.
        Returns (loss, aux); differentiable in ``params``."""
        x_final, kl_x, entropy, (var_x, var_y, cache_f, cache_b, y_tm) = self._rollout(
            params, u, y, generator, condition, noise
        )
        y_final = x_final[..., : self.dim_y]
        loglik = self._loglik(y_final, y_tm, var_y[: self.dim_y])  # [B]
        kw = dict(dtype=self.dtype, device=self.device)
        if weights is None:
            weights = torch.ones(y_tm.shape[1], **kw)
        weights = torch.as_tensor(weights, **kw)
        lam1, lam2 = (hyper(self.config.loss_factors[i]) for i in range(2))
        kl_zf = gp.prior_kl(params.gp_f, cache_f)
        kl_zb = gp.prior_kl(params.gp_b, cache_b)
        per_seq = lam1 * (loglik - kl_x) + lam2 * entropy
        particle_sum = torch.dot(per_seq, weights)
        global_term = -kl_zf - kl_zb
        # divided by a tensor, as parallel.mesh_loss divides the summed
        # terms: on the card, division by a Python number is a product with
        # its reciprocal, which can differ from it in the last bit
        divisor = torch.full((), float(self.samples), **kw)
        elbo = particle_sum / divisor + global_term
        aux = {
            "loglik": torch.dot(loglik, weights),
            "kl_x": torch.dot(kl_x, weights),
            "entropy": torch.dot(entropy, weights),
            "kl_z_f": kl_zf,
            "kl_z_b": kl_zb,
            "particle_sum": particle_sum,
            "particle_divisor": divisor,
            "global_term": global_term,
        }
        return -elbo, aux

    def predict(self, params: CBFSSMParams, u, y, generator=None, condition: bool = False,
                noise: RolloutNoise | None = None) -> PredictOutput:
        """Prediction statistics; with ``condition=False`` the rollout is
        free-running after the recognition prefix."""
        x_final, _, _, (_, var_y, _, _, y_tm) = self._rollout(
            params, u, y, generator, condition, noise
        )
        return self._prediction_stats(x_final, y_tm, var_y)
