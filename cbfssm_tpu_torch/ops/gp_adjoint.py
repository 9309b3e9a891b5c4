"""Hand-derived adjoint of the solve-free GP predict link (port of
``cbfssm_tpu/ops/gp_adjoint.py``).

Reverse-mode autograd through a time recursion sums the gradient of
every loop-invariant tensor (the cached inducing operators, the kernel
hyperparameters, the noise vectors) once per step. Those sums do not
feed the sequential chain; they only need each step's output
cotangents. The split schedule of ``adjoint='hand'``
(:mod:`cbfssm_tpu_torch.models.adjoint`) is built from three pieces:

* :func:`predict_batch` recomputes the predict intermediates of all
  time steps at once, so the primal stores nothing beyond its states;
* :func:`link_bwd` is the in-chain pullback of one link: the cotangent
  of its input rows only (three matmuls and elementwise work);
* :func:`deferred_cache_grads` forms the loop-invariant cotangents
  (kinv_alpha, var_q, kern_var, kern_len, z) once, after the reverse
  loop, as batched matmuls over the stacked per-step cotangents.

The math, for the predict of :func:`cbfssm_tpu_torch.ops.gp.predict`
with ``C = concat(K^-1, alpha)``, ``xs = x / len``, ``zs = z / len``::

  knm = kv * exp(-0.5 * max(|xs|^2 - 2 xs zs^T + |zs|^2, 0))
  wm  = knm @ C ; w = wm[:, :M] ; gm0 = wm[:, M:]
  qf  = sum_m knm * w
  gv0 = max(kv - qf, 0) + w^2 @ vq

  d_w   = 2 w * (d_gv0 @ vq^T) + d_qf * knm     with d_qf = -rpos * sum_d d_gv0
  d_wm  = [d_w | d_gm0]
  d_knm = d_wm @ C^T + d_qf * w
  d_d2  = -0.5 * knm * d_knm * d2pos
  d_xs  = (-2 d_d2) @ zs + 2 xs * rowsum(d_d2)
  d_gin = d_xs / len

  (deferred)  d_C  = knm^T @ d_wm          d_vq = (w^2)^T @ d_gv0
              d_kv = sum(rpos * sum_d d_gv0) + sum(d_knm * knm) / kv
              d_zs = (-2 d_d2)^T @ xs + 2 zs * colsum(d_d2) ; d_z = d_zs / len
              d_len = -(sum_N d_xs * x + sum_M d_zs * z) / len^2

The clamps take the strict masks ``d2pos = (raw > 0)`` and ``rpos =
(kv - qf > 0)``; autograd of ``clamp_min`` agrees except on the ties.
"""

from __future__ import annotations

import torch

from cbfssm_tpu_torch.ops import gp

# the GPCache fields the predict reads, in the order the adjoint
# Functions take them
LINK_FIELDS = ("kinv_alpha", "var_q", "kern_var", "kern_len", "z")


def link_tensors(cache: gp.GPCache) -> tuple:
    """The cache tensors of :data:`LINK_FIELDS`: what a time recursion
    differentiates through."""
    return tuple(getattr(cache, f) for f in LINK_FIELDS)


def link_cache(kinv_alpha, var_q, kern_var, kern_len, z) -> gp.GPCache:
    """A ``GPCache`` that :func:`gp.predict` reads like the full one,
    built from the :data:`LINK_FIELDS` tensors alone (``kinv`` and
    ``alpha`` are views of ``kinv_alpha``; the fields the predict does
    not read are None)."""
    m = kinv_alpha.shape[0]
    return gp.GPCache(chol=None, kinv=kinv_alpha[:, :m], kinv_diag=None,
                      alpha=kinv_alpha[:, m:], var_q=var_q, kern_var=kern_var,
                      kern_len=kern_len, z=z, inv_ls=None, zs=None, kinv_alpha=kinv_alpha)


def predict_batch(cache, gp_in) -> dict:
    """The predict intermediates of stacked rows ``gp_in`` [P, din]:
    a dict of [P, ...] tensors (see the module docstring), and the two
    clamp masks. The same ops on the same inputs as
    :func:`gp.predict`, so ``gm0`` / ``gv0`` equal its outputs bitwise.
    Divides ``z`` by the lengthscales as the predict does, rather than
    reading ``cache.zs`` (a reciprocal multiply, which differs in the
    last bit)."""
    m = cache.kinv_alpha.shape[0]
    ls = cache.kern_len
    xs = gp_in / ls
    zs = cache.z / ls
    xn = torch.sum(torch.square(xs), dim=-1)
    zn = torch.sum(torch.square(zs), dim=-1)
    d2raw = xn[:, None] - 2.0 * torch.matmul(xs, zs.T) + zn[None, :]
    knm = cache.kern_var * torch.exp(-0.5 * torch.clamp_min(d2raw, 0.0))
    wm = torch.matmul(knm, cache.kinv_alpha)
    w, gm0 = wm[:, :m], wm[:, m:]
    qf = torch.sum(knm * w, dim=-1)
    r = cache.kern_var - qf
    gv0 = torch.clamp_min(r, 0.0)[:, None] + torch.matmul(torch.square(w), cache.var_q)
    return {"xs": xs, "knm": knm, "w": w, "gm0": gm0, "gv0": gv0, "qf": qf,
            "d2pos": d2raw > 0.0, "rpos": r > 0.0}


def _d_knm_parts(cache, knm, w, rpos, d_gm0, d_gv0):
    """The shared head of the pullback: (d_qf, d_wm, d_knm)."""
    d_qf = -torch.where(rpos, torch.sum(d_gv0, dim=-1), 0.0)
    t1 = torch.matmul(d_gv0, cache.var_q.T)
    d_w = 2.0 * w * t1 + d_qf[:, None] * knm
    d_wm = torch.cat((d_w, d_gm0), dim=-1)
    d_knm = torch.matmul(d_wm, cache.kinv_alpha.T) + d_qf[:, None] * w
    return d_qf, d_wm, d_knm


def _d_xs(pre, d_d2, zs):
    return torch.matmul(-2.0 * d_d2, zs) + 2.0 * pre["xs"] * torch.sum(d_d2, dim=-1,
                                                                        keepdim=True)


def link_bwd(cache, pre_t: dict, d_gm0, d_gv0, zs=None):
    """In-chain pullback of one predict link: the cotangent ``d_gin``
    [N, din] of its input rows, from the output cotangents [N, D].
    ``pre_t`` is one step's rows of :func:`predict_batch`; ``zs`` is
    ``cache.z / cache.kern_len``, which a loop passes once for all its
    steps. The loop-invariant cotangents are left to
    :func:`deferred_cache_grads`."""
    knm = pre_t["knm"]
    _, _, d_knm = _d_knm_parts(cache, knm, pre_t["w"], pre_t["rpos"], d_gm0, d_gv0)
    d_d2 = torch.where(pre_t["d2pos"], -0.5 * knm * d_knm, 0.0)
    if zs is None:
        zs = cache.z / cache.kern_len
    return _d_xs(pre_t, d_d2, zs) / cache.kern_len


def deferred_cache_grads(cache, pre: dict, gp_in, d_gm0, d_gv0) -> gp.GPCache:
    """The loop-invariant cotangents over all stacked rows [P, ...]: a
    ``GPCache`` nonzero in the fields the predict reads (kinv_alpha,
    var_q, kern_var, kern_len, z) and zero in the others. ``d_kv`` takes
    the shape of ``cache.kern_var``."""
    knm, w = pre["knm"], pre["w"]
    ls = cache.kern_len
    _, d_wm, d_knm = _d_knm_parts(cache, knm, w, pre["rpos"], d_gm0, d_gv0)
    d_c = torch.matmul(knm.T, d_wm)
    d_vq = torch.matmul(torch.square(w).T, d_gv0)
    d_r = torch.where(pre["rpos"], torch.sum(d_gv0, dim=-1), 0.0)
    d_kv = (torch.sum(d_r) + torch.sum(d_knm * knm) / cache.kern_var).reshape(
        cache.kern_var.shape)
    d_d2 = torch.where(pre["d2pos"], -0.5 * knm * d_knm, 0.0)
    zs = cache.z / ls
    d_xs = _d_xs(pre, d_d2, zs)
    d_zs = torch.matmul((-2.0 * d_d2).T, pre["xs"]) + 2.0 * zs * torch.sum(d_d2, dim=0)[:, None]
    d_len = -(torch.sum(d_xs * gp_in, dim=0) + torch.sum(d_zs * cache.z, dim=0)) / torch.square(ls)
    zero = {f: (None if getattr(cache, f) is None else torch.zeros_like(getattr(cache, f)))
            for f in gp.GPCache.__dataclass_fields__}
    zero.update(kinv_alpha=d_c, var_q=d_vq, kern_var=d_kv, kern_len=d_len, z=d_zs / ls)
    return gp.GPCache(**zero)
