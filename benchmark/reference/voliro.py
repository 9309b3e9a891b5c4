"""Voliro (silvanmelchior/CBF-SSM ``run/run_voliro.py``: a physics + GP
model of an overactuated drone) in plain PyTorch and NumPy, and the
synthetic flight log it trains on here.

- :func:`make_raw`: the flip and tilt logs, PX4-style (a smooth
  sinusoid trajectory with a slowly turning attitude, uniform rotor PWM
  and tilt commands, a battery voltage) from the seed;
- :func:`windows`: the flip-log dataset layer: crop, attitude through
  Euler angles with yaw zeroed and the jump filter, Gaussian smoothing,
  finite-difference velocities and accelerations, battery-scaled PWM,
  halves for train and test, windows with the last one dropped;
- :func:`loss`: the negative ELBO: the rotor allocation and a force GP
  (12 -> 3) sampled once per time step and particle, a reverse
  recognition GP (19 -> 6), a symplectic-Euler rigid body conditioned
  on the recognised states every step, Beta priors on the GP noise and
  the force GP's lengthscales;
- :func:`gflop_per_step`: the analytic matmul operations of a step.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.io
import torch
from scipy.ndimage import gaussian_filter1d
from scipy.spatial.transform import Rotation

from benchmark.reference import common

LEAVES = ("gp_f.z", "gp_f.mean", "gp_f.var_unc", "gp_f.kern_var_unc", "gp_f.kern_len_unc",
          "gp_b.z", "gp_b.mean", "gp_b.var_unc", "gp_b.kern_var_unc", "gp_b.kern_len_unc",
          "var_x_unc", "var_y_unc", "var_z_unc")
LOG_KEYS = (["TIME_StartTime", "LPOS_X", "LPOS_Y", "LPOS_Z", "ATT_qw", "ATT_qx", "ATT_qy",
             "ATT_qz"] + [f"ATC{r}_Out{j}" for r in range(3) for j in range(6)] + ["BATT_VFilt"])
MASS = 4.04
INERTIA = (0.078359127, 0.081797886, 0.1533554115)
GRAVITY = (0.0, 0.0, 9.81)
ROTOR_FORCE = 0.000012 * 1700.0 ** 2  # force constant x (max rotor speed)^2
ROTOR_ANGLES = (0.5, -0.5, -1.0 / 6.0, 5.0 / 6.0, 1.0 / 6.0, 7.0 / 6.0)  # x pi
ARM = 0.3
DIM_Y_HIDDEN = 7  # observed position and attitude quaternion


# --- data ------------------------------------------------------------------


def quat_from_euler(roll, pitch, yaw):
    """wxyz quaternions of intrinsic x-y-z rotations."""
    q = Rotation.from_euler("XYZ", np.stack((roll, pitch, yaw), -1)).as_quat()
    return np.concatenate((q[:, 3:], q[:, :3]), 1)


def flight_log(n: int, seed: int) -> dict:
    """One log of ``n`` samples at 100 Hz."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    log = {"TIME_StartTime": t * 10_000.0, "LPOS_X": np.sin(t * 0.01),
           "LPOS_Y": np.cos(t * 0.013), "LPOS_Z": -1.0 + 0.1 * np.sin(t * 0.007)}
    q = quat_from_euler(0.2 * np.sin(t * 0.01), 0.1 * np.sin(t * 0.008), 0.3 + 0.05 * t * 0.001)
    for i, k in enumerate(("ATT_qw", "ATT_qx", "ATT_qy", "ATT_qz")):
        log[k] = q[:, i]
    for j in range(6):
        log[f"ATC0_Out{j}"] = rng.uniform(0.4, 0.8, n)  # upper rotor PWM
        log[f"ATC1_Out{j}"] = rng.uniform(0.4, 0.8, n)  # lower rotor PWM
        log[f"ATC2_Out{j}"] = rng.uniform(-0.5, 0.5, n)  # rotor tilt
    log["BATT_VFilt"] = 15.0 + 0.1 * np.sin(t * 0.002)
    return log


def make_raw(cfg, seed: int) -> dict:
    d = cfg["data"]
    return {"voliro_flip.mat": flight_log(int(d["flip_samples"]), seed),
            "voliro_tilt.mat": flight_log(int(d["tilt_samples"]), seed + 1)}


def write_raw(cfg, raw: dict, directory: str) -> None:
    """Both logs as the program's data layer reads them: a ``dataset``
    struct of (n, 1) arrays."""
    for name, log in raw.items():
        scipy.io.savemat(f"{directory}/{name}",
                         {"dataset": {k: log[k].reshape(-1, 1) for k in LOG_KEYS}})


def quat_multiply(a, b):
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return np.stack((aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw), -1)


def unwrap(angles, threshold=2.0 / 3.0 * np.pi):
    """The jump filter on each column: a rise above ``threshold`` over the
    previous filtered sample subtracts 2 pi; a fall below -threshold adds
    pi, or 2 pi where that still falls below -threshold."""
    out = angles.copy()
    for k in range(angles.shape[1]):
        prev = out[0, k]
        for i in range(1, angles.shape[0]):
            v = angles[i, k]
            if v - prev > threshold:
                v = v - 2 * np.pi
            elif v - prev < -threshold:
                v = v + np.pi if v + np.pi - prev >= -threshold else v + 2 * np.pi
            out[i, k] = prev = v
    return out


def log_arrays(log: dict, start: int, end: int):
    """(u [n, 13], y [n, 22]) of the crop [start, end) of a log."""
    sl = slice(start, end)
    pos = np.stack([log[k][sl] for k in ("LPOS_X", "LPOS_Y", "LPOS_Z")], 1)
    pos = pos - pos[0]
    q = np.stack([log[k][sl] for k in ("ATT_qx", "ATT_qy", "ATT_qz", "ATT_qw")], 1)
    rpy = Rotation.from_quat(q).as_euler("XYZ")
    rpy[:, 2] -= rpy[0, 2]
    rpy = unwrap(rpy)
    wxyz = quat_from_euler(rpy[:, 0], rpy[:, 1], rpy[:, 2])
    t = log["TIME_StartTime"]
    dt = (t[end] - t[start]) / float((end - start) * 1_000_000)
    pos_s, wxyz_s = gaussian_filter1d(pos, 25, axis=0), gaussian_filter1d(wxyz, 25, axis=0)
    linvel = np.zeros_like(pos)
    linvel[1:] = np.diff(pos_s, axis=0) / dt
    linacc = np.zeros_like(pos)
    linacc[1:-1] = np.diff(linvel, axis=0)[1:] / dt
    rot = Rotation.from_euler("XYZ", rpy).as_matrix()
    linacc += np.einsum("nji,j->ni", rot, np.asarray([0.0, 0.0, -9.81]))
    angvel = np.zeros_like(pos)
    conj = wxyz_s[1:] * np.asarray([1.0, -1.0, -1.0, -1.0])
    angvel[1:] = (2.0 * quat_multiply(np.diff(wxyz_s, axis=0) / dt, conj))[:, 1:]
    angacc = np.zeros_like(angvel)
    angacc[1:-1] = np.diff(angvel, axis=0)[1:] / dt
    pwm = np.stack([log[f"ATC0_Out{j}"][sl] for j in range(6)], 1)
    tilt = np.stack([log[f"ATC2_Out{j}"][sl] for j in range(6)], 1)
    battery = log["BATT_VFilt"][sl, None] / 25.0
    pwm = pwm * (battery * math.sqrt(39.622609152 / 36.3063891724) / battery[0, 0])
    u = np.concatenate((pwm, tilt, t[sl, None] / 1e6), 1)
    y = np.concatenate((pos, linvel, linacc * MASS, rpy, wxyz, angvel,
                        angacc * np.asarray(INERTIA)), 1)
    return u, y


def windows(cfg, raw: dict) -> dict:
    """Train and test windows of the flip log's two halves (raw units),
    the last window of each dropped."""
    d = cfg["data"]
    start, end = d["flip_crop"]
    u, y = log_arrays(raw["voliro_flip.mat"], start, end)
    half, length, stride = u.shape[0] // 2, int(d["seq_len"]), int(d["seq_stride"])

    def win(a):
        starts = list(range(0, a.shape[0] - length + 1, stride))
        if (a.shape[0] - length) % stride:
            starts.append(a.shape[0] - length)
        return np.stack([a[s:s + length] for s in starts])[:-1]

    return {"train": (win(u[:half]), win(y[:half])), "test": (win(u[half:]), win(y[half:]))}


# --- weights and draws --------------------------------------------------------


def leaf_shapes(cfg) -> list:
    n_m = int(cfg["model"]["ind_pnt_num"])
    return [(n_m, 12), (n_m, 3), (n_m, 3), (), (12,),
            (n_m, 19), (n_m, 6), (n_m, 6), (), (19,), (13,), (13,), (6,)]


def init(cfg, generator, dtype, device) -> list:
    """The initial leaves, in :data:`LEAVES` order (inducing inputs
    U(-zeta_pos, zeta_pos), means zeta_mean * U(0, 1), the rest at
    their configured values)."""
    m = cfg["model"]
    shapes = leaf_shapes(cfg)
    zf, mf, zb, mb = common.uniform_leaves(generator, [shapes[i] for i in (0, 1, 5, 6)],
                                           dtype, device)
    zp, zm = float(m["zeta_pos"]), float(m["zeta_mean"])

    def gp_leaves(z, mean, k):
        return [z * (2.0 * zp) - zp, zm * mean,
                common.constant_leaf(m["zeta_var"], shapes[k + 2], dtype, device),
                common.constant_leaf(m["gp_var"], (), dtype, device),
                common.constant_leaf(m["gp_len"], shapes[k + 4], dtype, device)]

    return [*gp_leaves(zf, mf, 0), *gp_leaves(zb, mb, 5)] + [
        common.constant_leaf(m[k], shapes[i], dtype, device)
        for i, k in ((10, "var_x"), (11, "var_y"), (12, "var_z"))]


def noise_shapes(cfg, batch: int, t_len: int) -> list:
    """The rollout's draws, in order: force [B, T, S, 1], recognition
    [T, B, S, 1], forward [T-1, B, S, 1]."""
    s = int(cfg["model"]["samples"])
    return [(batch, t_len, s, 1), (t_len, batch, s, 1), (t_len - 1, batch, s, 1)]


# --- the loss ---------------------------------------------------------------------


def allocation(dtype, device):
    """[12, 6]: the rotor coordinates (sin, cos) * pwm^2 to body force
    and torque."""
    a = np.zeros((6, 12))
    for i, ang in enumerate(np.asarray(ROTOR_ANGLES) * math.pi):
        a[0, 2 * i], a[1, 2 * i], a[5, 2 * i] = -math.cos(ang), -math.sin(ang), -ARM
        a[2, 2 * i + 1] = -1.0
        a[3, 2 * i + 1], a[4, 2 * i + 1] = -ARM * math.cos(ang), -ARM * math.sin(ang)
    return torch.tensor(a.T, dtype=dtype, device=device)


def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack((aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw), -1)


def rotate(v, q):
    """v [..., 3] rotated by the unit quaternions q: q (0, v) q*."""
    pure = torch.cat((torch.zeros_like(v[..., :1]), v), -1)
    conj = torch.cat((q[..., :1], -q[..., 1:]), -1)
    return qmul(qmul(q, pure), conj)[..., 1:]


def rigid_body_step(x, ft, dt):
    """Symplectic Euler of [pos, quat, linvel, angvel] under the body
    force and torque ``ft``: velocities first, then pose."""
    kw = dict(dtype=x.dtype, device=x.device)
    pos, rot, linvel, angvel = x[..., 0:3], x[..., 3:7], x[..., 7:10], x[..., 10:13]
    inertia_inv = 1.0 / torch.tensor(INERTIA, **kw)
    linvel = linvel + (rotate(ft[..., :3], rot) / MASS + torch.tensor(GRAVITY, **kw)) * dt
    angvel = angvel + rotate(inertia_inv * ft[..., 3:], rot) * dt
    spin = 0.5 * qmul(torch.cat((torch.zeros_like(angvel[..., :1]), angvel), -1), rot)
    pos = pos + linvel * dt
    rot = rot + spin * dt
    rot = rot / torch.sqrt(torch.sum(rot * rot, -1, keepdim=True))
    return torch.cat((pos, rot, linvel, angvel), -1)


def loss(cfg, leaves, u, y, weights, noise, prec: common.Precision):
    """Negative ELBO of the batch ``u`` [B, T, 13], ``y`` [B, T, 22]
    with pad weights [B] and the draws of :func:`noise_shapes`."""
    m = cfg["model"]
    dt_ = prec.dtype
    leaves = list(leaves)
    dev = leaves[0].device
    u, y, weights = (torch.as_tensor(a, dtype=dt_, device=dev) for a in (u, y, weights))
    eps_f, eps_b, eps_x = (n.to(dt_) for n in noise)
    jitter = float(m["jitter"])
    gp_f = common.GP(*leaves[0:5], jitter, prec)
    gp_b = common.GP(*leaves[5:10], jitter, prec)
    var_x, var_y, var_z = (common.positive(t) for t in leaves[10:13])
    b, t_len, _ = u.shape
    s = int(m["samples"])
    dt = (u[0, -1, 12] - u[0, 0, 12]) / t_len

    # the force model for every time step: physics + GP correction
    pwm2 = u[..., :6] ** 2
    coo = torch.stack((torch.sin(u[..., 6:12]) * pwm2, torch.cos(u[..., 6:12]) * pwm2),
                      -1).reshape(b * t_len, 12)
    phys = common.mm(coo, allocation(dt_, dev), prec) * ROTOR_FORCE
    fmean, fvar = gp_f.predict(coo)
    ft_mean = torch.cat((fmean + phys[:, :3], phys[:, 3:]), -1).reshape(b, t_len, 6)
    ft_var = (torch.cat((fvar, torch.zeros_like(fvar)), -1) + var_z).reshape(b, t_len, 6)
    ft = (ft_mean[:, :, None] + eps_f * torch.sqrt(ft_var[:, :, None])).permute(1, 0, 2, 3)
    yh = torch.cat((y[..., 0:3], y[..., 12:16]), -1).transpose(0, 1)  # [T, B, 7]

    # recognition: one reverse run
    h = torch.zeros((b, s, 6), dtype=dt_, device=dev)
    outs, entropy = [None] * t_len, 0.0
    for t in range(t_len - 1, -1, -1):
        gp_in = torch.cat((h, ft[t], yh[t][:, None].expand(b, s, DIM_Y_HIDDEN)), -1)
        fm, fv = common.predict_rows(gp_b, gp_in)
        h = fm + h + eps_b[t] * torch.sqrt(fv)
        outs[t] = h
        entropy = entropy + 0.5 * torch.sum(common.LOG_2PI_E + torch.log(fv), dim=(1, 2))
    y_tilde = torch.cat((yh[:, :, None].expand(t_len, b, s, DIM_Y_HIDDEN), torch.stack(outs)), -1)

    # the rigid body, conditioned on the recognised states every step
    x, xs, kl_x = y_tilde[0], [y_tilde[0]], 0.0
    for t in range(t_len - 1):
        fmean_x = rigid_body_step(x, ft[t], dt)
        gain = var_x / (var_y + var_x)
        mu = fmean_x + gain * (y_tilde[t + 1] - fmean_x)
        sig = (1.0 - gain) ** 2 * var_x + gain ** 2 * var_y
        x = mu + eps_x[t] * torch.sqrt(sig)
        xs.append(x)
        kl_x = kl_x + common.kl_diag(mu, sig, fmean_x, var_x.expand_as(fmean_x), (1, 2))
    x_final = torch.stack(xs)
    loglik = torch.sum(common.gaussian_logpdf(yh[:, :, None], x_final[..., :DIM_Y_HIDDEN],
                                              var_y[:DIM_Y_HIDDEN]), dim=(0, 2))
    n_a, n_b, n_scale = (float(v) for v in m["n_beta"])
    l_a, l_b, l_scale = (float(v) for v in m["l_beta"])
    n_reg = torch.sum(common.beta_logpdf(var_z / n_scale, n_a, n_b))
    l_reg = torch.sum(common.beta_logpdf(gp_f.kern_len / l_scale, l_a, l_b))
    lam = [float(v) for v in m["loglik_factor"]]
    per_seq = lam[0] * (loglik - kl_x) + lam[1] * entropy
    elbo = (torch.dot(per_seq, weights) / s + lam[2] * (n_reg + l_reg)
            - gp_f.prior_kl() - gp_b.prior_kl())
    return -elbo


# --- analytic operations ------------------------------------------------------


def gflop_per_step(cfg) -> float:
    """Matmul GFLOP of one optimizer step, the GP links only (the rigid
    body is elementwise): the force GP on B*T rows of 12 -> 3 and T
    recognition links on B*S rows of 19 -> 6, x3 for the backward pass.
    (A frozen copy of ``voliro_analytic_gflops`` in the port's bench.py,
    its sizes read from the configuration; 0.13000704 at run_voliro.py's.)"""
    m, d = cfg["model"], cfg["data"]
    n_m, b, t, s = int(m["ind_pnt_num"]), int(m["batch_size"]), int(d["seq_len"]), int(m["samples"])
    force = 2 * b * t * (12 * n_m + n_m * (n_m + 3) + n_m * 3)
    bwd = t * 2 * b * s * (19 * n_m + n_m * (n_m + 6) + n_m * 6)
    return 3.0 * (force + bwd) / 1e9
