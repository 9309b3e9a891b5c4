"""Plain PyTorch pieces the reference models share: the positive
transform, the RBF kernel, the sparse-GP predictive, Gaussian KLs,
Adam, the trainer's shuffle and draw rules, and TF32 emulation for the
control.

Written from the model's equations; imports nothing of the program.
Every matmul goes through :func:`mm`, so that the control (the
reference computed in TF32) rounds each operand to TF32's 10-bit
mantissa, nearest even, and accumulates in float32, as a TF32 tensor
core does up to its order of summation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

POSITIVE_FLOOR = 1e-10
LOG_2PI = math.log(2.0 * math.pi)
LOG_2PI_E = math.log(2.0 * math.pi * math.e)
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


class Precision:
    """How the reference computes: its float type and whether its
    matmuls round their operands to TF32."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounds float32 operands")
        self.dtype = dtype
        self.tf32 = tf32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def mm(a, b, prec: Precision):
    if prec.tf32:
        return torch.matmul(tf32_round(a), tf32_round(b))
    return torch.matmul(a, b)


def positive(x):
    """softplus(x) + 1e-10."""
    return torch.logaddexp(x, torch.zeros_like(x)) + POSITIVE_FLOOR


def positive_inverse(y) -> np.ndarray:
    """Inverse of :func:`positive` (float64, on the host)."""
    shifted = np.asarray(y, dtype=np.float64) - POSITIVE_FLOOR
    return np.where(shifted > 35.0, shifted, np.log(np.expm1(np.minimum(shifted, 35.0))))


def rbf_cross(x, z, kern_var, kern_len, prec):
    """kern_var * exp(-|(x - z) / kern_len|^2 / 2): [N, D] x [M, D] -> [N, M]."""
    xs, zs = x / kern_len, z / kern_len
    d2 = (torch.sum(xs * xs, -1)[:, None] - 2.0 * mm(xs, zs.T, prec)
          + torch.sum(zs * zs, -1)[None, :])
    return kern_var * torch.exp(-0.5 * torch.clamp_min(d2, 0.0))


class GP:
    """One inducing-point GP's operators for a loss evaluation: the
    jittered Gram factorized in float64 (then cast to the compute type),
    its inverse, alpha = K^-1 mean, and the constrained variances."""

    def __init__(self, z, mean, var_unc, kern_var_unc, kern_len_unc, jitter, prec):
        self.prec = prec
        self.z, self.mean = z, mean
        self.kern_var, self.kern_len = positive(kern_var_unc), positive(kern_len_unc)
        self.var_q = positive(var_unc)
        m = z.shape[0]
        gram = rbf_cross(z, z, self.kern_var, self.kern_len, prec)
        eye = torch.eye(m, dtype=torch.float64, device=z.device)
        self.chol = torch.linalg.cholesky(gram.to(torch.float64) + jitter * eye).to(z.dtype)
        linv = torch.linalg.solve_triangular(self.chol, eye.to(z.dtype), upper=False)
        self.kinv = mm(linv.T, linv, prec)
        self.alpha = mm(self.kinv, mean, prec)

    def predict(self, x):
        """Predictive mean and variance at the rows ``x`` [N, in] -> [N, out]."""
        knm = rbf_cross(x, self.z, self.kern_var, self.kern_len, self.prec)
        w = mm(knm, self.kinv, self.prec)
        fmean = mm(knm, self.alpha, self.prec)
        fvar = (torch.clamp_min(self.kern_var - torch.sum(knm * w, -1), 0.0)[:, None]
                + mm(w * w, self.var_q, self.prec))
        return fmean, fvar

    def prior_kl(self):
        """KL(N(mean, diag var_q) || N(0, K)), summed over output columns."""
        m = self.z.shape[0]
        logdet_k = 2.0 * torch.sum(torch.log(torch.diagonal(self.chol)))
        trace = torch.sum(torch.diagonal(self.kinv)[:, None] * self.var_q, 0)
        maha = torch.sum(self.mean * self.alpha, 0)
        return torch.sum(0.5 * (trace + maha - m + logdet_k - torch.sum(torch.log(self.var_q), 0)))


def predict_rows(gp, x):
    """:meth:`GP.predict` over rows ``x`` [..., in] -> ([..., out], [..., out])."""
    fm, fv = gp.predict(x.reshape(-1, x.shape[-1]))
    return fm.reshape(x.shape[:-1] + (-1,)), fv.reshape(x.shape[:-1] + (-1,))


def kl_diag(mean_q, var_q, mean_p, var_p, dims):
    return 0.5 * torch.sum(torch.log(var_p) - torch.log(var_q)
                           + (var_q + (mean_q - mean_p) ** 2) / var_p - 1.0, dim=dims)


def gaussian_logpdf(x, mean, var):
    """log N(x | mean, diag var), summed over the last axis."""
    return torch.sum(-0.5 * (LOG_2PI + torch.log(var) + (x - mean) ** 2 / var), -1)


def beta_logpdf(x, a: float, b: float):
    log_norm = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    return (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - log_norm


def constant_leaf(value, shape, dtype, device):
    """A leaf of ``shape`` filled with softplus^-1 of ``value`` (a scalar or
    a vector of the leaf's length)."""
    arr = np.broadcast_to(positive_inverse(value), shape)
    return torch.tensor(np.array(arr), dtype=dtype, device=device)


def uniform_leaves(generator, shapes, dtype, device):
    """U(0, 1) tensors of ``shapes`` from one draw of ``generator``."""
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.rand(sum(sizes), generator=generator, dtype=dtype, device=device)
    return [part.reshape(s) for part, s in zip(torch.split(flat, sizes), shapes)]


def draws(shapes, generator, dtype, device) -> list:
    """Standard-normal tensors of ``shapes`` from one call of ``generator``."""
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator, dtype=dtype, device=device)
    return [part.reshape(s) for part, s in zip(torch.split(flat, sizes), shapes)]


def trainer_draws(shapes, seed: int, epoch: int, split: int, i: int, dtype, device) -> list:
    """The draws a trainer seeded ``seed`` makes itself for batch ``i`` of
    ``split`` (0 train, 1 test) in ``epoch``: a generator on ``device``
    seeded by the first 64-bit word of ``SeedSequence([seed + 1, epoch,
    split, i])``, one standard-normal call a shape, in order."""
    word = np.random.SeedSequence([seed + 1, epoch, split, i]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(word))
    return [torch.randn(s, generator=gen, dtype=dtype, device=device) for s in shapes]


def epoch_batches(rng, n: int, batch: int):
    """(indices [n_batches, B], weights [n_batches, B]) of one shuffled
    epoch: a permutation of the ``n`` windows from ``rng``, padded to
    whole batches with window 0 at weight 0."""
    idx = rng.permutation(n)
    n_batches = -(-n // batch)
    padded = np.zeros(n_batches * batch, dtype=np.int64)
    padded[:n] = idx
    weights = np.zeros(n_batches * batch)
    weights[:n] = 1.0
    return padded.reshape(n_batches, batch), weights.reshape(n_batches, batch)


def first_batches(seed: int, n: int, batch: int, steps: int):
    """The windows and weights of the first ``steps`` optimizer steps of a
    trainer seeded ``seed``: epochs of shuffled batches, one generator
    ``np.random.default_rng(seed)`` for all shuffles."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < steps:
        idx, w = epoch_batches(rng, n, batch)
        out.extend(zip(idx, w))
    return out[:steps]


def adam_step(leaves, grads, m, v, t: int, lr: float):
    """One Adam step in place (lr, betas 0.9 / 0.999, eps 1e-8)."""
    with torch.no_grad():
        for p, g, mi, vi in zip(leaves, grads, m, v):
            mi.mul_(BETA1).add_(g, alpha=1.0 - BETA1)
            vi.mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
            m_hat = mi / (1.0 - BETA1 ** t)
            v_hat = vi / (1.0 - BETA2 ** t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))


def follow(loss_fn, leaves, batches, lr: float, prec: Precision):
    """The reference's own first steps: from ``leaves`` (any float type),
    for each ``(u, y, weights, noise)`` of ``batches`` the loss, its
    gradient and an Adam step, all in ``prec``. Returns (losses, first
    gradient, leaves after the last step), on the leaves' device."""
    params = [t.detach().to(prec.dtype).clone().requires_grad_(True) for t in leaves]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first_grad = [], None
    for t, (u, y, w, noise) in enumerate(batches, start=1):
        loss = loss_fn(params, u, y, w, noise, prec)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if first_grad is None:
            first_grad = [g.detach().clone() for g in grads]
        losses.append(float(loss.detach()))
        adam_step(params, grads, m, v, t, lr)
    return losses, first_grad, [p.detach() for p in params]
