"""The CBFSSM time-recursion step bodies (port of the two step bodies of
``cbfssm_tpu/models/adjoint.py``). The hand-scheduled VJPs of that
module (``forward_scan``, ``backward_scan``) belong to training and are
not ported here.

A step's boolean schedule flags (conditioning on/off, resample at the
block top) are static functions of the time index, so they arrive as
Python bools and pick a branch; the JAX step computes both sides and
selects with ``jnp.where``, which gives the same values.
"""

from __future__ import annotations

import torch

from cbfssm_tpu_torch.models.base import LOG_2PI_E
from cbfssm_tpu_torch.ops import gp
from cbfssm_tpu_torch.ops.distributions import kl_diag_gaussians


def forward_step(cache_f, var_x, var_y, k_factor, dims, gp_predict):
    """One transition of the conditioned particle rollout
    (cbfssm.py:185-237 semantics): residual GP transition, k-factor
    Kalman update toward the pseudo observation, per-step KL.

    ``step(x [B,S,dx], (u_t [B,du], y_next [B,S,dx], eps_t [B,S,1],
    cond_t bool)) -> (x_next, (x_next, kl_t [B]))``.
    """
    b, s, dx, du = dims

    def step(x, inp):
        u_t, y_next, eps_t, cond_t = inp
        u_bs = u_t[:, None, :].expand(b, s, du)
        gp_in = torch.cat((x, u_bs), dim=-1).reshape(b * s, -1)
        fmean, fvar = gp_predict(cache_f, gp_in)
        fmean = fmean.reshape(b, s, dx) + x  # residual transition
        fvar = fvar.reshape(b, s, dx) + var_x
        if not cond_t:
            x_next = fmean + eps_t * torch.sqrt(fvar)
            return x_next, (x_next, torch.zeros(b, dtype=x.dtype, device=x.device))
        var_y_t = var_y + (k_factor - 1.0) * fvar
        gain = fvar / (var_y_t + fvar)
        mu = fmean + gain * (y_next - fmean)
        sig = torch.square(1.0 - gain) * fvar + torch.square(gain) * var_y_t
        x_next = mu + eps_t * torch.sqrt(sig)
        kl_t = kl_diag_gaussians(mu, sig, fmean, fvar, axis=(1, 2))
        return x_next, (x_next, kl_t)

    return step


def backward_step(cache_b, var_x_h, dims, gp_predict):
    """One step of the blocked recognition recursion (cbfssm.py:114-158
    semantics in the block-parallel layout of ``CBFSSM._backward_blocked``).

    ``step(h [2,K,B,S,dh], (u_t [2,K,B,du], y_t [2,K,B,dy], z_t [2,K]
    bool, noise_t [2,K,B,S,1], eps_t [2,K,B,S,1], res_t bool)) ->
    (out, (out, ent_t [2,K,B]))``. ``z_t`` marks the (run, block) pairs
    that enter with the zero initial state.
    """
    n_runs, k_blk, b, s, dh, duy = dims
    shape_h = (n_runs, k_blk, b, s, dh)

    def step(h, inp):
        u_t, y_t, z_t, noise_t, eps_t, res_t = inp
        if res_t:
            h_in = noise_t.expand(shape_h)
        else:
            h_in = torch.where(z_t[:, :, None, None, None], 0.0, h)
        uy = torch.cat((u_t, y_t), dim=-1)[:, :, :, None, :].expand(
            n_runs, k_blk, b, s, duy
        )
        gp_in = torch.cat((h_in, uy), dim=-1)  # [2, K, B, S, dh+duy]
        fmean, fvar = gp.predict_rows(gp_predict, cache_b, gp_in, 2)
        fmean = fmean + h_in
        fvar = fvar + var_x_h
        out = fmean + eps_t * torch.sqrt(fvar)
        ent_t = 0.5 * torch.sum(LOG_2PI_E + torch.log(fvar), dim=(3, 4))
        return out, (out, ent_t)

    return step
