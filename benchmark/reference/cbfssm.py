"""CBF-SSM (Doerr et al.'s conditional backward/forward state-space
model as silvanmelchior/CBF-SSM trains it) in plain PyTorch, and the
RoboMove data it trains on here.

- :func:`make_raw`: the partially observed RoboMove rollout
  (``create_datasets/create_robomove.py --partial``: a unicycle robot
  under the return-to-origin policy, position measured), its random
  numbers drawn in bulk from the seed.
- :func:`windows`: the dataset layer (z-score over the whole log, split
  at ``split``, windows of ``seq_len`` every ``seq_stride`` with the
  tail window).
- :func:`loss`: the negative ELBO. The recognition pass is written as
  the published two-run reverse recursion over all T steps (run r
  resamples where (t + 1 + r L) % 2L == 0 and writes where
  (t % 2L < L) == (r == 0)). Its draws are taken in the block layout
  the program consumes (``noise_layout``): run r at time t reads row
  t + r L.
- :func:`gflop_per_step`: the analytic matmul operations of a step.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.io
import torch

from benchmark.reference import common

LEAVES = ("gp_f.z", "gp_f.mean", "gp_f.var_unc", "gp_f.kern_var_unc", "gp_f.kern_len_unc",
          "gp_b.z", "gp_b.mean", "gp_b.var_unc", "gp_b.kern_var_unc", "gp_b.kern_len_unc",
          "var_x_unc", "var_y_unc")


# --- data ------------------------------------------------------------------


def make_raw(cfg, seed: int) -> dict:
    """(u [N, 2], y [N, 2]) of the RoboMove rollout: state [pos, orient],
    control [speed, curvature] from the policy, position measured."""
    d = cfg["data"]
    n, sx, sy = int(d["steps"]), float(d["sigma_x"]), float(d["sigma_y"])
    rng = np.random.default_rng(seed)
    proc = rng.normal(0.0, math.sqrt(sx), (n, 2))
    meas = rng.normal(0.0, math.sqrt(sy), (n, 2))
    explore = np.stack((rng.uniform(-0.1, 0.5, n), rng.binomial(1, 0.3, n),
                        rng.uniform(-1.5, 1.5, n)), 1).tolist()
    arc = np.stack((rng.uniform(0.2, 0.5, n), rng.uniform(0.5, 0.8, n),
                    rng.binomial(1, 0.5, n) * 2.0 - 1.0), 1).tolist()
    px = py = orient = 0.0
    state, arc_val, arc_t = 0, (0.0, 0.0), 0
    u = np.empty((n, 2))
    pos = np.empty((n, 2))
    for i in range(n):
        pos[i] = px, py
        if math.hypot(px, py) < 5.0:  # explore near the origin
            state = 0
            speed = max(0.0, explore[i][0])
            curv = 0.0 if explore[i][1] else explore[i][2]
        else:  # an arc back, its curvature decaying
            if state == 0:
                state, arc_t = 1, i
                arc_val = (arc[i][0], arc[i][1] * arc[i][2])
            speed = arc_val[0]
            curv = 0.8 * arc_val[1] + 0.2 * arc_val[1] / (i - arc_t + 1)
        u[i] = speed, curv
        sin_o, cos_o = math.sin(orient), math.cos(orient)
        if abs(curv) < 1e-5:
            px, py = px + sin_o * speed, py + cos_o * speed
        else:
            sign = math.copysign(1.0, curv)
            nx, ny = cos_o * sign, -sin_o * sign
            radius = 1.0 / abs(curv)
            angle = speed / radius * sign
            c, s = math.cos(angle), math.sin(angle)
            px += (nx - (c * nx + s * ny)) * radius
            py += (ny - (-s * nx + c * ny)) * radius
            orient += angle
        px, py = px + proc[i, 0], py + proc[i, 1]
        orient %= 2.0 * math.pi
    return {"u": u, "y": pos + meas}


def write_raw(cfg, raw: dict, directory: str) -> None:
    """The rollout as the program's data layer reads it: ``ds_u``,
    ``ds_x``, ``ds_y`` and ``title`` in ``cfg['data']['file']``."""
    n = raw["u"].shape[0]
    scipy.io.savemat(f"{directory}/{cfg['data']['file']}",
                     {"ds_u": raw["u"], "ds_x": np.zeros((n, 3)), "ds_y": raw["y"],
                      "title": "RoboMove"})


def rnn_windows(x, length: int, stride: int):
    """Windows [n, length, dim] of ``x`` [time, dim] every ``stride``
    steps, plus the last ``length`` steps when the stride leaves a tail."""
    starts = list(range(0, x.shape[0] - length + 1, stride))
    if (x.shape[0] - length) % stride:
        starts.append(x.shape[0] - length)
    return np.stack([x[s:s + length] for s in starts])


def windows(cfg, raw: dict) -> dict:
    """Train and test windows ``{'train': (u, y), 'test': (u, y)}``."""
    d = cfg["data"]

    def zscore(a):
        centred = a - a.mean(0)
        return (a - a.mean(0)) / centred.std(0)

    u, y = zscore(raw["u"]), zscore(raw["y"])
    split, length, stride = int(d["split"]), int(d["seq_len"]), int(d["seq_stride"])
    return {"train": (rnn_windows(u[:split], length, stride), rnn_windows(y[:split], length, stride)),
            "test": (rnn_windows(u[split:], length, stride), rnn_windows(y[split:], length, stride))}


# --- weights and draws ----------------------------------------------------------


def leaf_shapes(cfg) -> list:
    m = cfg["model"]
    n_m, dx = int(m["ind_pnt_num"]), int(m["dim_x"])
    du, dy = int(cfg["data"]["dim_u"]), int(cfg["data"]["dim_y"])
    din, dh = dx + du, dx - dy
    return [(n_m, din), (n_m, dx), (n_m, dx), (), (din,),
            (n_m, din), (n_m, dh), (n_m, dh), (), (din,), (dx,), (dx,)]


def init(cfg, generator, dtype, device) -> list:
    """The initial leaves, in :data:`LEAVES` order: inducing inputs
    U(-zeta_pos, zeta_pos), means zeta_mean * U(0, 1), every variance
    and kernel hyperparameter at its configured value."""
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

    return [*gp_leaves(zf, mf, 0), *gp_leaves(zb, mb, 5),
            common.constant_leaf(m["var_x"], shapes[10], dtype, device),
            common.constant_leaf(m["var_y"], shapes[11], dtype, device)]


def noise_layout(cfg, t_len: int) -> tuple:
    """(t_b, shifts): the rows of the recognition draws, T + the block
    padding (2L-blocks covering T + L), and each run's row offset."""
    two_l = 2 * int(cfg["model"]["recog_len"])
    t_ext = -(-(t_len + two_l // 2) // two_l) * two_l
    return t_ext, (0, two_l // 2)


def noise_shapes(cfg, batch: int, t_len: int) -> list:
    """The rollout's draws, in order: backward resample [t_b, 2, B, S, 1],
    backward transition (same), forward transition [T-1, B, S, 1]."""
    s = int(cfg["model"]["samples"])
    t_b, _ = noise_layout(cfg, t_len)
    return [(t_b, 2, batch, s, 1), (t_b, 2, batch, s, 1), (t_len - 1, batch, s, 1)]


# --- the loss ---------------------------------------------------------------------


def loss(cfg, leaves, u, y, weights, noise, prec: common.Precision):
    """Negative ELBO of the batch ``u`` [B, T, du], ``y`` [B, T, dy]
    with pad weights [B] and the draws of :func:`noise_shapes`."""
    m = cfg["model"]
    dt = prec.dtype
    leaves = list(leaves)
    u, y, weights = (torch.as_tensor(a, dtype=dt, device=leaves[0].device)
                     for a in (u, y, weights))
    noise = [n.to(dt) for n in noise]
    jitter = float(m["jitter"])
    gp_f = common.GP(*leaves[0:5], jitter, prec)
    gp_b = common.GP(*leaves[5:10], jitter, prec)
    var_x, var_y = common.positive(leaves[10]), common.positive(leaves[11])
    b, t_len, dy = y.shape
    dx, s, rl = int(m["dim_x"]), int(m["samples"]), int(m["recog_len"])
    dh = dx - dy
    u_tm, y_tm = u.transpose(0, 1), y.transpose(0, 1)
    _, shifts = noise_layout(cfg, t_len)

    # recognition: two reverse runs over all T steps
    h = torch.zeros((2, b, s, dh), dtype=dt, device=u.device)
    y2, ent = [None] * t_len, [None] * t_len
    for t in range(t_len - 1, -1, -1):
        rows = [t + sh for sh in shifts]
        resample = [(t + 1 + r * rl) % (2 * rl) == 0 for r in range(2)]
        h_in = torch.stack([noise[0][rows[r], r].expand(b, s, dh) if resample[r] else h[r]
                            for r in range(2)])
        uy = torch.cat((u_tm[t], y_tm[t]), -1)[None, :, None, :].expand(2, b, s, -1)
        fmean, fvar = common.predict_rows(gp_b, torch.cat((h_in, uy), -1))
        fmean, fvar = fmean + h_in, fvar + var_x[:dh]
        eps = torch.stack([noise[1][rows[r], r] for r in range(2)])
        h = fmean + eps * torch.sqrt(fvar)
        run = 0 if t % (2 * rl) < rl else 1
        y2[t] = h[run]
        ent[t] = 0.5 * torch.sum(common.LOG_2PI_E + torch.log(fvar[run]), dim=(1, 2))
    entropy = torch.sum(torch.stack(ent), 0)
    y_tilde = torch.cat((y_tm[:, :, None, :].expand(t_len, b, s, dy), torch.stack(y2)), -1)

    # conditioned forward rollout (training conditions every step)
    k_factor = float(m["k_factor"])
    x, xs, kls = y_tilde[0], [y_tilde[0]], []
    for t in range(t_len - 1):
        gp_in = torch.cat((x, u_tm[t][:, None, :].expand(b, s, -1)), -1)
        fmean, fvar = common.predict_rows(gp_f, gp_in)
        fmean, fvar = fmean + x, fvar + var_x
        var_y_t = var_y + (k_factor - 1.0) * fvar
        gain = fvar / (var_y_t + fvar)
        mu = fmean + gain * (y_tilde[t + 1] - fmean)
        sig = (1.0 - gain) ** 2 * fvar + gain ** 2 * var_y_t
        x = mu + noise[2][t] * torch.sqrt(sig)
        xs.append(x)
        kls.append(common.kl_diag(mu, sig, fmean, fvar, (1, 2)))
    x_final = torch.stack(xs)
    kl_x = torch.sum(torch.stack(kls), 0)
    loglik = torch.sum(common.gaussian_logpdf(y_tm[:, :, None, :], x_final[..., :dy],
                                              var_y[:dy]), dim=(0, 2))
    lam1, lam2 = (float(v) for v in m["loss_factors"])
    per_seq = lam1 * (loglik - kl_x) + lam2 * entropy
    elbo = torch.dot(per_seq, weights) / s - gp_f.prior_kl() - gp_b.prior_kl()
    return -elbo


# --- analytic operations ------------------------------------------------------


def gflop_per_step(cfg) -> float:
    """Matmul GFLOP of one optimizer step: the GP links of both
    recursions, [N, din] x [din, M], [N, M] x [M, M + out] and
    [N, M] x [M, out] each, x3 for the backward pass. The recognition
    counts its 2L steps over the 2 * blocks * B * S rows of the block
    layout. (A frozen copy of ``cbfssm_analytic_gflops`` in the port's
    bench.py; 117.20256 at the RoboMove widths.)"""
    m, d = cfg["model"], cfg["data"]
    t, n_m = int(d["seq_len"]), int(m["ind_pnt_num"])
    dx, du, dy = int(m["dim_x"]), int(d["dim_u"]), int(d["dim_y"])
    dh, din, n = dx - dy, dx + du, int(m["batch_size"]) * int(m["samples"])
    fwd = (t - 1) * 2 * n * (din * n_m + n_m * (n_m + dx) + n_m * dx)
    two_l = 2 * int(m["recog_len"])
    bwd = 0
    if dh > 0 and t > two_l:
        t_ext, _ = noise_layout(cfg, t)
        nb = 2 * (t_ext // two_l) * n
        bwd = two_l * 2 * nb * (din * n_m + n_m * (n_m + dh) + n_m * dh)
    return 3.0 * (fwd + bwd) / 1e9
