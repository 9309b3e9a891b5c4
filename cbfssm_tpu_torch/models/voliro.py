"""Voliro: a physics + GP hybrid model of an overactuated drone (port of
``cbfssm_tpu/models/voliro.py``).

- Control mapping: per rotor (sin tilt, cos tilt) * pwm^2 gives 12
  local coordinates; a fixed 6x12 allocation matrix maps them to the
  body-frame force and torque.
- A sparse GP (12 -> 3) corrects the force, with learned GP noise var_z.
  The correction is sampled once per (batch, time, particle) and shared
  across the 6 force/torque dims. It is predicted for all time steps in
  one batched GP call on B*T rows.
- The forward dynamics is a deterministic symplectic-Euler rigid-body
  integrator over [pos(3), quat(4), linvel(3), angvel(3)]; process noise
  var_x is the transition variance.
- A single-run backward (recognition) GP, 19 -> 6, conditions on
  [h(6), ft_gp(6), observed pos+quat(7)], one GP call per time step.
- The ELBO adds Beta priors on the GP noise and the force GP's
  lengthscales.

dt comes from the time channel (u[..., 12]) of the first sequence of the
batch. Each GP call is ``BaseSSM._gp_predict``: the fused CUDA kernel
under ``gp_impl='pallas'``. Both recursions are step functions run in a
plain loop; with ``adjoint='parallel'`` (``gp_impl='solve_free'``) the
loop is :func:`cbfssm_tpu_torch.ops.parallel_vjp.scan_outputs_vjp`, whose
backward has log depth. The three draws of a rollout are taken
ready-made as ``noise=`` (a :class:`VoliroNoise`, :meth:`Voliro.draw_noise`)
or drawn from a ``torch.Generator``, in the JAX package's shapes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cbfssm_tpu_torch.models.base import (LOG_2PI_E, BaseSSM, hyper, moments_over_samples,
                                         noise_tensors)
from cbfssm_tpu_torch.ops import gp, gp_adjoint, parallel_vjp, quaternion, transforms
from cbfssm_tpu_torch.ops.distributions import beta_logpdf, kl_diag_gaussians


def allocation_matrix() -> np.ndarray:
    """6x12 rotor-geometry allocation matrix: columns alternate (sin,
    cos) components per rotor; rows are [fx, fy, fz, tx, ty, tz]."""
    angles = np.asarray([0.5, -0.5, -1.0 / 6.0, 5.0 / 6.0, 1.0 / 6.0, 7.0 / 6.0]) * math.pi
    arm_length = 0.3
    a = np.zeros((6, 12))
    for i, ang in enumerate(angles):
        a[0, 2 * i] = -math.cos(ang)
        a[1, 2 * i] = -math.sin(ang)
        a[2, 2 * i + 1] = -1.0
        a[3, 2 * i + 1] = -arm_length * math.cos(ang)
        a[4, 2 * i + 1] = -arm_length * math.sin(ang)
        a[5, 2 * i] = -arm_length
    return a


@dataclasses.dataclass
class VoliroParams:
    gp_f: gp.SparseGPParams  # force correction GP: 12 -> 3
    gp_b: gp.SparseGPParams  # backward GP: 19 -> 6
    var_x_unc: torch.Tensor  # [13]
    var_y_unc: torch.Tensor  # [13]
    var_z_unc: torch.Tensor  # [6] GP force/torque noise

    def tensors(self) -> list:
        """The leaves in a fixed order (gp_f's, gp_b's in
        ``SparseGPParams`` field order, then var_x_unc, var_y_unc,
        var_z_unc): the optimizer's parameter list and the checkpoint
        layout."""
        return [*self.gp_f.tensors(), *self.gp_b.tensors(), self.var_x_unc, self.var_y_unc,
                self.var_z_unc]

    def with_tensors(self, tensors) -> "VoliroParams":
        """Params with the leaves ``tensors``, in :meth:`tensors` order."""
        t = list(tensors)
        n = len(gp.SparseGPParams.__dataclass_fields__)
        if len(t) != 2 * n + 3:
            raise ValueError(f"VoliroParams takes {2 * n + 3} tensors, got {len(t)}")
        return VoliroParams(gp.SparseGPParams(*t[:n]), gp.SparseGPParams(*t[n:2 * n]),
                            t[2 * n], t[2 * n + 1], t[2 * n + 2])

    def to(self, *args, **kwargs) -> "VoliroParams":
        """Every leaf through ``Tensor.to(*args, **kwargs)``."""
        return self.with_tensors([t.to(*args, **kwargs) for t in self.tensors()])

    def detach(self) -> "VoliroParams":
        """The same values, cut from autograd."""
        return self.with_tensors([t.detach() for t in self.tensors()])


@dataclasses.dataclass
class VoliroNoise:
    """The standard-normal draws of one rollout, shared across state
    dimensions (trailing axis 1), in the order the JAX package splits
    its key (``kz, kb, kf``)."""

    force: torch.Tensor  # [B, T, S, 1] force-GP samples
    backward: torch.Tensor  # [T, B, S, 1] recognition transitions
    forward: torch.Tensor  # [T-1, B, S, 1] conditioned forward transitions

    BATCH_AXES = (0, 1, 1)  # each field's batch axis (parallel.noise_rows)


class Voliro(BaseSSM):
    # loss-time fields this model reads: loglik_factor and the Beta
    # priors, not loss_factors / k_factor
    SWEEPABLE_HYPERS = frozenset({"loglik_factor", "n_beta", "l_beta"})
    SUPPORTED_ADJOINTS = frozenset({"auto", "autodiff", "parallel"})
    # parameter-only aux entries
    REPLICATED_AUX = frozenset(
        {"kl_z_f", "kl_z_b", "n_reg", "l_reg", "global_term", "particle_divisor"}
    )
    # filter_step takes two draws per step: (force, state)
    FILTER_DRAWS = 2

    # Fixed physical dimensions.
    GP_DIM_IN_F = 12
    GP_DIM_OUT_F = 3
    GP_DIM_IN_B = 19
    GP_DIM_OUT_B = 6
    DIM_Y = 7  # pos(3) + quat(4)
    DIM_X = 13

    ROTOR_FORCE_CONSTANT = 0.000012
    ROTOR_SPEED_MAX = 1700.0
    MASS = 4.04
    INERTIA = (0.078359127, 0.081797886, 0.1533554115)
    GRAVITY = (0.0, 0.0, 9.81)

    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        self.dim_x = self.DIM_X
        # the model's observation space is the 7-dim hidden projection of
        # the 22-dim dataset output (out_to_hidden)
        self.model_dim_y = self.DIM_Y
        kw = dict(dtype=self.dtype, device=self.device)
        self.alloc = torch.tensor(allocation_matrix(), **kw)
        self.post_scale = self.ROTOR_FORCE_CONSTANT * self.ROTOR_SPEED_MAX**2
        self.mass_inv = 1.0 / self.MASS
        self.inertia_inv = torch.tensor([1.0 / i for i in self.INERTIA], **kw)
        self.gravity = torch.tensor(self.GRAVITY, **kw)
        self._check_noise_lengths(var_x=self.DIM_X, var_y=self.DIM_X, var_z=6)

    def init(self, generator: torch.Generator) -> VoliroParams:
        """Random parameters: gp_f, then gp_b, from ``generator``."""
        cfg = self.config
        gp_kwargs = dict(num_points=cfg.ind_pnt_num, gp_var=cfg.gp_var, gp_len=cfg.gp_len,
                         zeta_mean=cfg.zeta_mean, zeta_pos=cfg.zeta_pos,
                         zeta_var=cfg.zeta_var, dtype=self.dtype, device=self.device)
        return VoliroParams(
            gp_f=gp.init_sparse_gp(generator, self.GP_DIM_IN_F, self.GP_DIM_OUT_F, **gp_kwargs),
            gp_b=gp.init_sparse_gp(generator, self.GP_DIM_IN_B, self.GP_DIM_OUT_B, **gp_kwargs),
            var_x_unc=self._noise_unc(cfg.var_x),
            var_y_unc=self._noise_unc(cfg.var_y),
            var_z_unc=self._noise_unc(cfg.var_z),
        )

    def draw_noise(self, generator: torch.Generator, t_len: int, b: int,
                   out: VoliroNoise | None = None) -> VoliroNoise:
        """The rollout's three draws, in the JAX package's shapes; with
        ``out`` (draws of these shapes) written into its tensors."""
        s = self.samples
        outs = (None,) * 3 if out is None else noise_tensors(out)
        return VoliroNoise(self._shared_eps(generator, (b, t_len, s), outs[0]),
                           self._shared_eps(generator, (t_len, b, s), outs[1]),
                           self._shared_eps(generator, (t_len - 1, b, s), outs[2]))

    def var_dict(self, params: VoliroParams) -> dict:
        """Named hyper/variational parameters (the reference var_dump)."""
        return {
            "process noise": transforms.positive(params.var_x_unc),
            "observation noise": transforms.positive(params.var_y_unc),
            "gp noise": transforms.positive(params.var_z_unc),
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

    # --- physics --------------------------------------------------------

    @staticmethod
    def out_to_hidden(y):
        """Dataset observation [..., 22] -> model observation [..., 7]:
        position (0:3) and quaternion (12:16)."""
        return torch.cat((y[..., 0:3], y[..., 12:16]), dim=-1)

    def local_coordinates(self, u):
        """u [..., 13] -> 12 local rotor coordinates
        (sin tilt_k, cos tilt_k) * pwm_k^2, interleaved."""
        pwm, tilt = u[..., :6], u[..., 6:12]
        fac = torch.square(pwm)
        stacked = torch.stack((torch.sin(tilt) * fac, torch.cos(tilt) * fac), dim=-1)
        return stacked.reshape(u.shape[:-1] + (12,))

    def physical_model(self, local_coo):
        """Allocation-matrix force/torque [..., 6]. On the card in
        float32 this matmul runs in IEEE float32 (TF32 is refused)."""
        alloc_t = self.alloc.T
        if alloc_t.device.type == "cpu":  # as in kernels.scaled_square_dist
            alloc_t = alloc_t.contiguous()
        return torch.matmul(local_coo, alloc_t) * self.post_scale

    @staticmethod
    def infer_dt(u):
        """dt from the time channel of the first sequence of the batch:
        (t[-1] - t[0]) / T, as the reference divides."""
        ts = u[0, :, 12]
        return (ts[-1] - ts[0]) / ts.shape[0]

    def symplectic_euler(self, x, force_torque, dt):
        """One symplectic-Euler step of the rigid body.
        x: [..., 13], force_torque: [..., 6]."""
        pos, rot = x[..., 0:3], x[..., 3:7]
        linvel, angvel = x[..., 7:10], x[..., 10:13]

        f_glob = quaternion.rotate_vector(force_torque[..., :3], rot)
        t_glob = quaternion.rotate_vector(self.inertia_inv * force_torque[..., 3:], rot)

        linvel = linvel + (self.mass_inv * f_glob + self.gravity) * dt
        angvel = angvel + t_glob * dt

        rot_diff = 0.5 * quaternion.multiply(quaternion.from_vector(angvel), rot)
        pos = pos + linvel * dt
        rot = quaternion.normalize(rot + rot_diff * dt)
        return torch.cat((pos, rot, linvel, angvel), dim=-1)

    # --- GP force correction -------------------------------------------

    def _force_distribution(self, cache_f, var_z, local_coo, force_torque):
        """Mean and variance [..., 6] of the corrected force/torque at
        rows ``local_coo`` [N, 12] (physics ``force_torque`` [N, 6])."""
        fmean, fvar = self._gp_predict(cache_f, local_coo)
        ft_mean = torch.cat((fmean + force_torque[..., :3], force_torque[..., 3:]), dim=-1)
        ft_var = torch.cat((fvar, torch.zeros_like(force_torque[..., 3:])), dim=-1) + var_z
        return ft_mean, ft_var

    def gp_forces(self, cache_f, var_z, u_bt, eps):
        """Force/torque distribution and particle samples for all time
        steps at once, in one GP call on B*T rows.

        u_bt: [B, T, 13], eps: [B, T, S, 1] -> (ft_gp [B, T, S, 6],
        ft_mean [B, T, 6], ft_var [B, T, 6], force_torque [B, T, 6])
        """
        b, t = u_bt.shape[0], u_bt.shape[1]
        local_coo = self.local_coordinates(u_bt).reshape(b * t, self.GP_DIM_IN_F)
        force_torque = self.physical_model(local_coo)
        ft_mean, ft_var = self._force_distribution(cache_f, var_z, local_coo, force_torque)
        ft_mean, ft_var = ft_mean.reshape(b, t, 6), ft_var.reshape(b, t, 6)
        ft_gp = ft_mean[:, :, None, :] + eps * torch.sqrt(ft_var[:, :, None, :])
        return ft_gp, ft_mean, ft_var, force_torque.reshape(b, t, 6)

    # --- backward pass --------------------------------------------------

    def _backward_step(self, b: int):
        """The recognition step ``step(cache, h [B,S,6], (ft_t [B,S,6],
        y_t [B,7], eps_t [B,S,1])) -> (out, (out, ent_t [B]))``: input
        [h(6), ft_gp(6), y_hidden(7)], residual on h, no var_x added."""
        s, dh = self.samples, self.GP_DIM_OUT_B

        def step(cache, h, inp):
            ft_t, y_t, eps_t = inp
            y_bs = y_t[:, None, :].expand(b, s, self.DIM_Y)
            gp_in = torch.cat((h, ft_t, y_bs), dim=-1).reshape(b * s, -1)
            fmean, fvar = self._gp_predict(cache, gp_in)
            fmean = fmean.reshape(b, s, dh) + h
            fvar = fvar.reshape(b, s, dh)
            out = fmean + eps_t * torch.sqrt(fvar)
            return out, (out, 0.5 * torch.sum(LOG_2PI_E + torch.log(fvar), dim=(1, 2)))

        return step

    def _backward(self, cache_b, ft_gp_tm, yh_tm, eps):
        """Single-run reverse-time recognition.

        ft_gp_tm: [T, B, S, 6], yh_tm: [T, B, 7], eps: [T, B, S, 1] ->
        (y_tilde [T, B, S, 13], entropy [B])
        """
        t_len, b = yh_tm.shape[0], yh_tm.shape[1]
        step = self._backward_step(b)
        h = torch.zeros((b, self.samples, self.GP_DIM_OUT_B), dtype=self.dtype,
                        device=self.device)
        if self._parallel_adjoint:
            # per-particle state (dh = 6): a latency-bound recursion, so
            # the log-depth reverse pays (ops/parallel_vjp.py)
            outs, ents = parallel_vjp.scan_outputs_vjp(
                lambda consts, hh, inp: step(gp_adjoint.link_cache(*consts), hh, inp),
                gp_adjoint.link_tensors(cache_b), h,
                (ft_gp_tm.flip(0), yh_tm.flip(0), eps.flip(0)))
            outs = outs.flip(0)
        else:
            outs, ents = [None] * t_len, []
            for t in reversed(range(t_len)):
                h, (_, ent_t) = step(cache_b, h, (ft_gp_tm[t], yh_tm[t], eps[t]))
                outs[t] = h
                ents.append(ent_t)
            outs = torch.stack(outs)
        entropy = 0.0
        for ent_t in ents:  # descending t, the order of the recursion
            entropy = entropy + ent_t
        y_obs = yh_tm[:, :, None, :].expand(t_len, b, self.samples, self.DIM_Y)
        return torch.cat((y_obs, outs), dim=-1), entropy

    # --- forward pass ---------------------------------------------------

    def _forward_step(self, b: int):
        """The physics step with always-on conditioning on y_tilde:
        ``step((var_x, var_y, dt), x [B,S,13], (ft_t [B,S,6], y_next
        [B,S,13], eps_t [B,S,1])) -> (x_next, (x_next, kl_t [B]))``."""
        s, dx = self.samples, self.DIM_X

        def step(consts, x, inp):
            var_x, var_y, dt = consts
            ft_t, y_next, eps_t = inp
            fmean = self.symplectic_euler(x, ft_t, dt)
            fvar = var_x.expand(b, s, dx)
            gain = fvar / (var_y + fvar)
            mu = fmean + gain * (y_next - fmean)
            sig = torch.square(1.0 - gain) * fvar + torch.square(gain) * var_y
            x_next = mu + eps_t * torch.sqrt(sig)
            return x_next, (x_next, kl_diag_gaussians(mu, sig, fmean, fvar, axis=(1, 2)))

        return step

    def _forward(self, var_x, var_y, y_tilde, ft_gp_tm, dt, eps):
        """Physics rollout with always-on conditioning on y_tilde."""
        t_len, b = y_tilde.shape[0], y_tilde.shape[1]
        step = self._forward_step(b)
        consts, x = (var_x, var_y, dt), y_tilde[0]
        if self._parallel_adjoint and t_len > 1:
            # per-particle state (dx = 13): the physics and conditioning
            # link is tiny, so the log-depth reverse (ops/parallel_vjp.py)
            x_rest, kls = parallel_vjp.scan_outputs_vjp(
                step, consts, x, (ft_gp_tm[:-1], y_tilde[1:], eps))
            xs = torch.cat((x[None], x_rest))
        else:
            xs, kls = [x], []
            for t in range(t_len - 1):
                x, (_, kl_t) = step(consts, x, (ft_gp_tm[t], y_tilde[t + 1], eps[t]))
                xs.append(x)
                kls.append(kl_t)
            xs = torch.stack(xs)
        kl_x = torch.zeros(b, dtype=self.dtype, device=self.device)
        for kl_t in kls:
            kl_x = kl_x + kl_t
        return xs, kl_x

    # --- ELBO -----------------------------------------------------------

    def _noise(self, noise, generator, t_len, b) -> VoliroNoise:
        """``noise`` on the model's device, checked against the rollout's
        shapes, or a draw from ``generator`` when it is None."""
        if noise is None:
            if generator is None:
                raise ValueError("need a generator or ready-made noise")
            return self.draw_noise(generator, t_len, b)
        s = self.samples
        return VoliroNoise(self._eps_or_draw(noise.force, None, (b, t_len, s)),
                           self._eps_or_draw(noise.backward, None, (t_len, b, s)),
                           self._eps_or_draw(noise.forward, None, (t_len - 1, b, s)))

    def _rollout(self, params: VoliroParams, u, y, generator=None, noise=None):
        self._check_precision()
        var_x = transforms.positive(params.var_x_unc)
        var_y = transforms.positive(params.var_y_unc)
        var_z = transforms.positive(params.var_z_unc)
        # one batched factorization for both GPs
        cache_f, cache_b = gp.precompute_pair(params.gp_f, params.gp_b, self.jitter)

        kw = dict(dtype=self.dtype, device=self.device)
        u_bt, y_bt = torch.as_tensor(u, **kw), torch.as_tensor(y, **kw)
        b, t_len = u_bt.shape[0], u_bt.shape[1]
        noise = self._noise(noise, generator, t_len, b)
        dt = self.infer_dt(u_bt)

        ft_gp, ft_mean, ft_var, force_torque = self.gp_forces(cache_f, var_z, u_bt, noise.force)
        ft_gp_tm = ft_gp.permute(1, 0, 2, 3)  # [T, B, S, 6]
        yh_tm = self.out_to_hidden(y_bt).transpose(0, 1)  # [T, B, 7]

        y_tilde, entropy = self._backward(cache_b, ft_gp_tm, yh_tm, noise.backward)
        x_final, kl_x = self._forward(var_x, var_y, y_tilde, ft_gp_tm, dt, noise.forward)
        extras = {"force_torque": force_torque, "ft_mean": ft_mean, "ft_var": ft_var,
                  "var_x": var_x, "var_y": var_y, "var_z": var_z, "cache_f": cache_f,
                  "cache_b": cache_b, "yh_tm": yh_tm}
        return x_final, kl_x, entropy, extras

    def loss(self, params: VoliroParams, u, y, generator=None, condition: bool = True,
             weights=None, noise=None):
        """Negative ELBO with the Beta priors, and its aux dict.
        ``condition`` has no effect: Voliro always conditions."""
        del condition
        cfg = self.config
        x_final, kl_x, entropy, ex = self._rollout(params, u, y, generator, noise)
        loglik = self._loglik(x_final[..., : self.DIM_Y], ex["yh_tm"], ex["var_y"][: self.DIM_Y])

        kw = dict(dtype=self.dtype, device=self.device)
        weights = (torch.ones(x_final.shape[1], **kw) if weights is None
                   else torch.as_tensor(weights, **kw))
        kl_zf = gp.prior_kl(params.gp_f, ex["cache_f"])
        kl_zb = gp.prior_kl(params.gp_b, ex["cache_b"])

        n_a, n_b, n_scale = cfg.n_beta
        l_a, l_b, l_scale = cfg.l_beta
        n_reg = torch.sum(beta_logpdf(ex["var_z"] / n_scale, n_a, n_b))
        l_reg = torch.sum(beta_logpdf(params.gp_f.kern_len / l_scale, l_a, l_b))

        lam = [hyper(cfg.loglik_factor[i]) for i in range(3)]
        per_seq = lam[0] * (loglik - kl_x) + lam[1] * entropy
        particle_sum = torch.dot(per_seq, weights)
        global_term = lam[2] * (n_reg + l_reg) - kl_zf - kl_zb
        # divided by a tensor, as parallel.mesh_loss divides (see CBFSSM.loss)
        divisor = torch.full((), float(self.samples), **kw)
        elbo = particle_sum / divisor + global_term
        aux = {
            "loglik": torch.dot(loglik, weights),
            "kl_x": torch.dot(kl_x, weights),
            "entropy": torch.dot(entropy, weights),
            "kl_z_f": kl_zf,
            "kl_z_b": kl_zb,
            "n_reg": n_reg,
            "l_reg": l_reg,
            "particle_sum": particle_sum,
            "particle_divisor": divisor,
            "global_term": global_term,
        }
        return -elbo, aux

    def predict(self, params: VoliroParams, u, y, generator=None, condition: bool = True,
                noise=None) -> dict:
        """Moments of the full 13-dim state plus var_y, and the
        force-model outputs the Voliro plots use: a dict, not a
        ``PredictOutput``, so the batch predictors refuse this model."""
        del condition
        x_final, _, _, ex = self._rollout(params, u, y, generator, noise)
        mean, var0 = moments_over_samples(x_final.permute(1, 0, 2, 3))
        return {
            "pred_mean": mean,
            "pred_var": var0 + ex["var_y"],
            "force_torque": ex["force_torque"],
            "ft_mean": ex["ft_mean"],
            "ft_var": ex["ft_var"],
        }

    # --- streaming/online filtering --------------------------------------
    #
    # The training-time conditioning target comes from the backward
    # smoother over future observations and cannot be computed online.
    # The filter below is its causal counterpart: the training transition
    # (local_coordinates -> allocation matrix -> force-GP sample ->
    # symplectic Euler) with the Kalman-style update restricted to the
    # observed pos(3)+quat(4), zero gain on the velocities. forecast is
    # free-run prediction under the trained dynamics.

    def _filter_dt(self) -> float:
        dt = self.config.filter_dt
        if dt is None:
            raise ValueError(
                "Voliro online filtering needs config['filter_dt'] (the stream's "
                "uniform sampling period; training infers it from each sequence's "
                "time channel, infer_dt)"
            )
        dt = float(dt)
        if dt <= 0:
            raise ValueError(f"filter_dt must be positive, got {dt}")
        return dt

    def filter_ops(self, params: VoliroParams):
        """(force-GP cache, var_x, var_y, var_z, dt): the loop-invariant
        operators. The backward GP is absent: it is the training-time
        smoother, unusable online."""
        self._check_precision()
        return (
            gp.precompute(params.gp_f, self.jitter),
            transforms.positive(params.var_x_unc),
            transforms.positive(params.var_y_unc),
            transforms.positive(params.var_z_unc),
            torch.tensor(self._filter_dt(), dtype=self.dtype, device=self.device),
        )

    def filter_init(self, params: VoliroParams, u_prefix, y_prefix):
        """Ensemble x_0 [B, S, 13] from the last two observations of a
        warmup window: pos/quat read off, linvel by finite differences,
        angvel by inverting the integrator's small-angle quaternion
        update, w ~ (2/dt) vec((rot1 - rot0) x conj(rot0))."""
        del params
        self._check_precision()
        if y_prefix.shape[1] < 2:
            raise ValueError(
                "Voliro filter_init needs a warmup window of >= 2 observations for "
                f"velocity estimates, got {tuple(y_prefix.shape)}"
            )
        kw = dict(dtype=self.dtype, device=self.device)
        dt = torch.tensor(self._filter_dt(), **kw)
        yh = self.out_to_hidden(torch.as_tensor(y_prefix, **kw))
        pos0, pos1 = yh[:, -2, :3], yh[:, -1, :3]
        q0 = quaternion.normalize(yh[:, -2, 3:7])
        q1 = quaternion.normalize(yh[:, -1, 3:7])
        linvel = (pos1 - pos0) / dt
        dq = quaternion.multiply(q1 - q0, quaternion.conjugate(q0))
        angvel = (2.0 / dt) * dq[..., 1:4]
        x0 = torch.cat((pos1, q1, linvel, angvel), dim=-1)
        return x0[:, None, :].expand(x0.shape[0], self.samples, self.DIM_X)

    def _filter_eps(self, eps, generator, lead, b, s):
        """(eps_ft, eps_x), each ``lead + (b, s, 1)``: from ``eps`` (a
        pair, or a tensor with the pair on axis ``len(lead)``) or drawn
        from ``generator``, force first."""
        if eps is None:
            if generator is None:
                raise ValueError("need a generator or ready-made noise")
            return (self._shared_eps(generator, lead + (b, s)),
                    self._shared_eps(generator, lead + (b, s)))
        if isinstance(eps, torch.Tensor) and eps.dim() == len(lead) + 4:
            eps = eps.unbind(len(lead))
        eps_ft, eps_x = eps
        return (self._eps_or_draw(eps_ft, None, lead + (b, s)),
                self._eps_or_draw(eps_x, None, lead + (b, s)))

    def _free_step(self, cache_f, var_z, x, u_t, eps_ft, dt):
        """The propagation of one step: force-GP sample for the control
        row u_t [B, 13], then symplectic Euler -> fmean [B, S, 13]."""
        local_coo = self.local_coordinates(u_t)
        ft_mean, ft_var = self._force_distribution(cache_f, var_z, local_coo,
                                                   self.physical_model(local_coo))
        ft_gp = ft_mean[:, None, :] + eps_ft * torch.sqrt(ft_var[:, None, :])
        return self.symplectic_euler(x, ft_gp, dt)

    def filter_step(self, params, ops, x, u_prev, y_new, generator=None, eps=None):
        """One online conditioned transition of the particle ensemble.

        u_prev [B, 13] (the applied rotor PWM/tilt row; its time channel
        is ignored, dt comes from ``ops``), y_new [B, 22] (only pos+quat
        are read). ``eps`` overrides the (force, state) draws, [B, S, 1]
        each, as a pair or stacked [2, B, S, 1]. Returns (x_next
        [B, S, 13], (mean [B, 7], var [B, 7])): the filtered pos+quat
        moments including observation noise."""
        del params
        self._check_precision()
        cache_f, var_x, var_y, var_z, dt = ops
        b, s = x.shape[0], x.shape[1]
        eps_ft, eps_x = self._filter_eps(eps, generator, (), b, s)
        kw = dict(dtype=self.dtype, device=self.device)
        fmean = self._free_step(cache_f, var_z, x, torch.as_tensor(u_prev, **kw), eps_ft, dt)
        fvar = var_x.expand(b, s, self.DIM_X)

        # conditioning on the observed dims only (pos+quat = x[..., :7])
        dy, pad = self.DIM_Y, self.DIM_X - self.DIM_Y
        yh = self.out_to_hidden(torch.as_tensor(y_new, **kw))
        y_bs = yh[:, None, :].expand(b, s, dy)

        def pad_h(a):
            return torch.nn.functional.pad(a, (0, pad))

        var_y_o = var_y[:dy]
        gain = fvar[..., :dy] / (var_y_o + fvar[..., :dy])
        mu = fmean + pad_h(gain * (y_bs - fmean[..., :dy]))
        sig = torch.square(1.0 - pad_h(gain)) * fvar + pad_h(torch.square(gain) * var_y_o)
        x_next = mu + eps_x * torch.sqrt(sig)

        y_part = x_next[..., :dy]
        mean = torch.mean(y_part, dim=1)
        var = torch.mean(torch.square(y_part - mean[:, None, :]), dim=1) + var_y_o
        return x_next, (mean, var)

    def forecast(self, params, ops, x, u_future, generator=None, eps=None):
        """Free-run rollout from the current ensemble under planned
        controls (physics + force-GP sampling + process noise, no
        conditioning). u_future [B, H, 13] -> (mean [B, H, 7],
        var [B, H, 7]); the caller's ensemble is not advanced. ``eps``
        overrides the (force, state) draws, [H, B, S, 1] each."""
        del params
        self._check_precision()
        cache_f, var_x, var_y, var_z, dt = ops
        b, s = x.shape[0], x.shape[1]
        u_tm = self._time_major(u_future)
        h = u_tm.shape[0]
        eps_ft, eps_x = self._filter_eps(eps, generator, (h,), b, s)
        sd_x = torch.sqrt(var_x.expand(b, s, self.DIM_X))
        path = []
        for t in range(h):
            x = self._free_step(cache_f, var_z, x, u_tm[t], eps_ft[t], dt) + eps_x[t] * sd_x
            path.append(x)
        y_part = torch.stack(path)[..., : self.DIM_Y]  # [H, B, S, 7]
        mean = torch.mean(y_part, dim=2)
        var = torch.mean(torch.square(y_part - mean[:, :, None, :]), dim=2) + var_y[: self.DIM_Y]
        return mean.transpose(0, 1), var.transpose(0, 1)
