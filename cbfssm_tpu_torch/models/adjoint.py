"""The CBFSSM time recursions: their step bodies, and the hand-scheduled
adjoints of both rollouts (port of ``cbfssm_tpu/models/adjoint.py``).

Autograd through the Python loop of a rollout re-traverses the chain
with every cotangent sum of a loop-invariant tensor (GP cache operators,
kernel hyperparameters, noise vectors) inside the reverse loop. The
``adjoint='hand'`` rollouts, :class:`ForwardScan` and
:class:`BackwardScan`, are ``torch.autograd.Function``s whose backward
has three phases:

1. one batched recompute of every step's predict intermediates from the
   stacked states the primal already returns
   (:func:`gp_adjoint.predict_batch`);
2. a reverse loop that carries only the state cotangent, through
   :func:`gp_adjoint.link_bwd` and elementwise algebra;
3. the loop-invariant cotangents once, batched over all steps
   (:func:`gp_adjoint.deferred_cache_grads` and plain sums).

Their forward runs the step bodies below in a plain loop, so the primal
is the autodiff path's bit for bit. The GP cache enters as the tensors
of :data:`gp_adjoint.LINK_FIELDS`; their cotangents flow on through
autograd into ``gp.precompute_pair``. The hand adjoint applies to
``gp_impl='solve_free'`` only (``BaseSSM`` refuses it with 'pallas').

A step's boolean schedule flags (conditioning on/off, resample at the
block top) are static functions of the time index, so they arrive as
Python bools and pick a branch, in the primal and in the reverse loop
alike; the JAX step computes both sides and selects with ``jnp.where``,
which gives the same values. Both Functions set ``generate_vmap_rule``,
so the lane trainers' ``torch.func.vmap`` carries them.
"""

from __future__ import annotations

import numpy as np
import torch

from cbfssm_tpu_torch.models.base import LOG_2PI_E
from cbfssm_tpu_torch.ops import gp, gp_adjoint
from cbfssm_tpu_torch.ops.distributions import kl_diag_gaussians
from cbfssm_tpu_torch.utils.transfer import constant


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


def _rows(pre: dict, steps: int, n: int) -> list:
    """``predict_batch``'s rows [steps * n, ...] as one dict of [n, ...]
    views per step (the keys ``link_bwd`` reads)."""
    keys = ("knm", "w", "xs", "d2pos", "rpos")
    split = {k: pre[k].reshape((steps, n) + tuple(pre[k].shape[1:])) for k in keys}
    return [{k: split[k][t] for k in keys} for t in range(steps)]


# --------------------------------------------------------------------------
# Forward (generative / conditioning) rollout
# --------------------------------------------------------------------------


class ForwardScan(torch.autograd.Function):
    """The conditioned particle rollout over ``T-1`` transitions with the
    hand-scheduled backward.

    ``apply(cond, kinv_alpha, var_q, kern_var, kern_len, z, var_x, var_y,
    k_factor, x0, u_in, y_next_in, eps_in)``: ``cond`` a tuple of T-1
    bools; the five cache tensors of ``gp_f``; x0 [B,S,dx]; u_in
    [T-1,B,du]; y_next_in [T-1,B,S,dx]; eps_in [T-1,B,S,1]; ``k_factor``
    a float or a 0-d tensor (a swept lane's) -> (x_rest [T-1,B,S,dx],
    kl_steps [T-1,B]).
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(cond, kinv_alpha, var_q, kern_var, kern_len, z, var_x, var_y, k_factor, x0,
                u_in, y_next_in, eps_in):
        cache = gp_adjoint.link_cache(kinv_alpha, var_q, kern_var, kern_len, z)
        b, s, dx = x0.shape
        step = forward_step(cache, var_x, var_y, k_factor, (b, s, dx, u_in.shape[-1]),
                            gp.predict)
        x, xs, kls = x0, [], []
        for t, cond_t in enumerate(cond):
            x, (_, kl_t) = step(x, (u_in[t], y_next_in[t], eps_in[t], cond_t))
            xs.append(x)
            kls.append(kl_t)
        return torch.stack(xs), torch.stack(kls)

    @staticmethod
    def setup_context(ctx, inputs, output):
        cond, *tensors = inputs
        k_factor = tensors[7]
        ctx.cond = cond
        ctx.k_is_tensor = isinstance(k_factor, torch.Tensor)
        if not ctx.k_is_tensor:
            ctx.k_factor = k_factor
            tensors[7] = None
        ctx.save_for_backward(*tensors, output[0])

    @staticmethod
    def backward(ctx, d_x_rest, d_kl_steps):
        (kinv_alpha, var_q, kern_var, kern_len, z, var_x, var_y, k_factor, x0, u_in,
         y_next_in, eps_in, x_rest) = ctx.saved_tensors
        if not ctx.k_is_tensor:
            k_factor = ctx.k_factor
        cond = ctx.cond
        cache = gp_adjoint.link_cache(kinv_alpha, var_q, kern_var, kern_len, z)
        t1, (b, s, dx), du = len(cond), x0.shape, u_in.shape[-1]
        n = b * s

        # ---- phase 1: batched recompute of the per-step intermediates ----
        x_in = torch.cat((x0[None], x_rest[:-1]))
        u_bs = u_in[:, :, None, :].expand(t1, b, s, du)
        gp_in_all = torch.cat((x_in, u_bs), dim=-1).reshape(t1 * n, dx + du)
        pre = gp_adjoint.predict_batch(cache, gp_in_all)
        fmean = pre["gm0"].reshape(t1, b, s, dx) + x_in
        fvar = pre["gv0"].reshape(t1, b, s, dx) + var_x
        vyt = var_y + (k_factor - 1.0) * fvar
        s_den = vyt + fvar
        gain = fvar / s_den
        one_m_gain = 1.0 - gain
        mu = fmean + gain * (y_next_in - fmean)
        sig = torch.square(one_m_gain) * fvar + torch.square(gain) * vyt
        cond_b = constant(("adjoint.cond", cond), lambda: np.asarray(cond), x0.device)
        cond_b = cond_b[:, None, None, None]
        sqrt_su = torch.sqrt(torch.where(cond_b, sig, fvar))
        # the conditioned steps' pullback is linear in (d_x_next, d_kl):
        # its coefficients, batched over all steps
        e_coef = eps_in * (0.5 / sqrt_su)
        inv_fvar = 1.0 / fvar
        dm = mu - fmean
        c_mu = 2.0 * dm * inv_fvar
        a_fvar = inv_fvar - (sig + dm * dm) * inv_fvar * inv_fvar
        b_sig = inv_fvar - 1.0 / sig
        g_sig = 2.0 * gain * vyt - 2.0 * one_m_gain * fvar
        y_m_f = y_next_in - fmean
        gain2 = torch.square(gain)
        fvar_s = fvar / torch.square(s_den)
        vyt_s = vyt / torch.square(s_den)
        p_sig = torch.square(one_m_gain) + (k_factor - 1.0) * gain2
        q_gain = vyt_s - (k_factor - 1.0) * fvar_s
        rows = _rows(pre, t1, n)
        zs = z / kern_len

        # ---- phase 2: reverse loop, state cotangent only ----
        d_x = torch.zeros_like(x0)
        d_gm0, d_gv0, d_u, d_mu, d_sig, d_gain, d_xn = ([None] * t1 for _ in range(7))
        for t in reversed(range(t1)):
            d_xn_tot = d_x + d_x_rest[t]
            if cond[t]:
                g = 0.5 * d_kl_steps[t][:, None, None]
                d_mu_t = torch.addcmul(d_xn_tot, g, c_mu[t])
                d_sig_t = torch.addcmul(d_xn_tot * e_coef[t], g, b_sig[t])
                d_fmean = d_mu_t * one_m_gain[t] - g * c_mu[t]
                d_gain_t = torch.addcmul(d_sig_t * g_sig[t], d_mu_t, y_m_f[t])
                d_fvar = torch.addcmul(torch.addcmul(g * a_fvar[t], d_sig_t, p_sig[t]),
                                       d_gain_t, q_gain[t])
                d_mu[t], d_sig[t], d_gain[t] = d_mu_t, d_sig_t, d_gain_t
            else:
                d_fmean, d_fvar = d_xn_tot, d_xn_tot * e_coef[t]
            d_gin = gp_adjoint.link_bwd(cache, rows[t], d_fmean.reshape(n, dx),
                                        d_fvar.reshape(n, dx), zs=zs)
            d_x = d_gin[:, :dx].reshape(b, s, dx) + d_fmean
            d_gm0[t], d_gv0[t], d_u[t], d_xn[t] = d_fmean, d_fvar, d_gin[:, dx:], d_xn_tot

        # ---- phase 3: the loop-invariant cotangents, batched ----
        d_gm0_all, d_gv0_all = torch.stack(d_gm0), torch.stack(d_gv0)
        d_cache = gp_adjoint.deferred_cache_grads(
            cache, pre, gp_in_all, d_gm0_all.reshape(t1 * n, dx), d_gv0_all.reshape(t1 * n, dx))
        zero = torch.zeros_like(x0)

        def stacked(parts):  # the unconditioned steps' entries are zero
            return torch.stack([zero if p is None else p for p in parts])

        d_vyt = stacked(d_sig) * gain2 - stacked(d_gain) * fvar_s
        d_k = None
        if ctx.k_is_tensor and ctx.needs_input_grad[8]:
            d_k = torch.sum(d_vyt * fvar).reshape(k_factor.shape)
        d_u_in = torch.sum(torch.stack(d_u).reshape(t1, b, s, du), dim=2)
        d_eps = torch.sum(torch.stack(d_xn) * sqrt_su, dim=-1, keepdim=True)
        return (None, *gp_adjoint.link_tensors(d_cache), torch.sum(d_gv0_all, dim=(0, 1, 2)),
                torch.sum(d_vyt, dim=(0, 1, 2)), d_k, d_x, d_u_in, stacked(d_mu) * gain, d_eps)


def forward_scan(cond, cache, var_x, var_y, k_factor, x0, u_in, y_next_in, eps_in):
    """:class:`ForwardScan` on a ``GPCache``: (x_rest, kl_steps)."""
    return ForwardScan.apply(tuple(bool(c) for c in cond), *gp_adjoint.link_tensors(cache),
                             var_x, var_y, k_factor, x0, u_in, y_next_in, eps_in)


# --------------------------------------------------------------------------
# Backward (recognition) blocked rollout
# --------------------------------------------------------------------------


class BackwardScan(torch.autograd.Function):
    """The blocked recognition rollout over ``two_l`` steps (descending
    t') with the hand-scheduled backward.

    ``apply(res, kinv_alpha, var_q, kern_var, kern_len, z, var_x_h, h0,
    u_in, y_in, z_in, noise_in, eps_in)``: ``res`` a tuple of two_l
    bools (resample at the step); the five cache tensors of ``gp_b``;
    h0 [2,K,B,S,dh]; u_in [two_l,2,K,B,du]; y_in [two_l,2,K,B,dy]; z_in
    [two_l,2,K] bool (the reset to the zero state); noise_in / eps_in
    [two_l,2,K,B,S,1] -> (outs [two_l,2,K,B,S,dh], ents [two_l,2,K,B]).
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(res, kinv_alpha, var_q, kern_var, kern_len, z, var_x_h, h0, u_in, y_in, z_in,
                noise_in, eps_in):
        cache = gp_adjoint.link_cache(kinv_alpha, var_q, kern_var, kern_len, z)
        n_runs, k_blk, b, s, dh = h0.shape
        step = backward_step(cache, var_x_h,
                             (n_runs, k_blk, b, s, dh, u_in.shape[-1] + y_in.shape[-1]),
                             gp.predict)
        h, outs, ents = h0, [], []
        for i, res_i in enumerate(res):
            h, (out, ent_t) = step(h, (u_in[i], y_in[i], z_in[i], noise_in[i], eps_in[i], res_i))
            outs.append(out)
            ents.append(ent_t)
        return torch.stack(outs), torch.stack(ents)

    @staticmethod
    def setup_context(ctx, inputs, output):
        res, *tensors = inputs
        ctx.res = res
        ctx.save_for_backward(*tensors, output[0])

    @staticmethod
    def backward(ctx, d_outs, d_ents):
        (kinv_alpha, var_q, kern_var, kern_len, z, var_x_h, h0, u_in, y_in, z_in, noise_in,
         eps_in, outs) = ctx.saved_tensors
        res = ctx.res
        cache = gp_adjoint.link_cache(kinv_alpha, var_q, kern_var, kern_len, z)
        two_l, n_runs, k_blk, b, du = u_in.shape
        s, dh, dy = h0.shape[3], h0.shape[4], y_in.shape[-1]
        n = n_runs * k_blk * b * s
        lead = (n_runs, k_blk, b, s)

        # ---- phase 1: batched recompute, rows in layout order ----
        prev_out = torch.cat((h0[None], outs[:-1]))
        h_carry = torch.where(z_in[:, :, :, None, None, None], 0.0, prev_out)
        res_b = constant(("adjoint.res", res), lambda: np.asarray(res), h0.device)
        res_b = res_b[:, None, None, None, None, None]
        h_in = torch.where(res_b, noise_in, h_carry)  # [two_l, 2, K, B, S, dh]
        uy = torch.cat((u_in, y_in), dim=-1)[:, :, :, :, None, :].expand(
            (two_l,) + lead + (du + dy,))
        gp_in_all = torch.cat((h_in, uy), dim=-1).reshape(two_l * n, dh + du + dy)
        pre = gp_adjoint.predict_batch(cache, gp_in_all)
        fvar = pre["gv0"].reshape((two_l,) + lead + (dh,)) + var_x_h
        sqrt_fvar = torch.sqrt(fvar)
        # out = fmean + eps sqrt(fvar); ent = 0.5 sum(log(2 pi e) + log fvar)
        e_coef = eps_in * (0.5 / sqrt_fvar)
        h_coef = 0.5 / fvar
        rows = _rows(pre, two_l, n)
        zs = z / kern_len

        # ---- phase 2: reverse loop, state cotangent only ----
        d_h = torch.zeros_like(h0)
        d_gm0, d_gv0, d_noise, d_out_all, d_uy = ([None] * two_l for _ in range(5))
        for i in reversed(range(two_l)):
            d_out = d_h + d_outs[i]
            d_fvar = torch.addcmul(d_out * e_coef[i], d_ents[i][:, :, :, None, None], h_coef[i])
            d_gin = gp_adjoint.link_bwd(cache, rows[i], d_out.reshape(n, dh),
                                        d_fvar.reshape(n, dh), zs=zs)
            d_h_in = d_gin[:, :dh].reshape(lead + (dh,)) + d_out
            # h_in = noise at a resample, else where(z, 0, h)
            if res[i]:
                d_h = torch.zeros_like(h0)
                d_noise[i] = torch.sum(d_h_in, dim=-1, keepdim=True)
            else:
                d_h = torch.where(z_in[i][:, :, None, None, None], 0.0, d_h_in)
            d_gm0[i], d_gv0[i], d_out_all[i], d_uy[i] = d_out, d_fvar, d_out, d_gin[:, dh:]

        # ---- phase 3: the loop-invariant cotangents, batched ----
        d_gv0_all = torch.stack(d_gv0)
        d_cache = gp_adjoint.deferred_cache_grads(
            cache, pre, gp_in_all, torch.stack(d_gm0).reshape(two_l * n, dh),
            d_gv0_all.reshape(two_l * n, dh))
        d_uy_all = torch.stack(d_uy).reshape((two_l,) + lead + (du + dy,))
        d_eps = torch.sum(torch.stack(d_out_all) * sqrt_fvar, dim=-1, keepdim=True)
        zero = torch.zeros_like(noise_in[0])  # the noise enters only at a resample
        d_noise_all = torch.stack([zero if d is None else d for d in d_noise])
        return (None, *gp_adjoint.link_tensors(d_cache),
                torch.sum(d_gv0_all, dim=(0, 1, 2, 3, 4)), d_h,
                torch.sum(d_uy_all[..., :du], dim=4), torch.sum(d_uy_all[..., du:], dim=4), None,
                d_noise_all, d_eps)


def backward_scan(res, cache, var_x_h, h0, u_in, y_in, z_in, noise_in, eps_in):
    """:class:`BackwardScan` on a ``GPCache``: (outs, ents)."""
    return BackwardScan.apply(tuple(bool(r) for r in res), *gp_adjoint.link_tensors(cache),
                              var_x_h, h0, u_in, y_in, z_in, noise_in, eps_in)
