"""Variational sparse (inducing-point) GP (port of ``cbfssm_tpu/ops/gp.py``).

q(f(x)) has mean ``K_nm K^-1 m`` and variance
``k(x,x) - diag(K_nm K^-1 K_mn) + sum_m var_q[m,:] * (K_nm K^-1)_m^2``.
The M x M Gram is factorized once per call (:func:`precompute`) and
``K^-1`` and ``alpha = K^-1 m`` are formed explicitly, so each step of a
time recursion is one cross-Gram and a few matmuls (:func:`predict`), or
one fused CUDA kernel (:func:`predict_fast`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from cbfssm_tpu_torch.ops import kernels, linalg, transforms
from cbfssm_tpu_torch.ops.distributions import kl_diag_vs_tril
from cbfssm_tpu_torch.ops.fused_predict import fused_predict


@dataclass
class SparseGPParams:
    """Trainable state of one inducing-point GP."""

    z: torch.Tensor  # [M, in_dim] inducing-point positions
    mean: torch.Tensor  # [M, out_dim] variational mean
    var_unc: torch.Tensor  # [M, out_dim] unconstrained variational variance
    kern_var_unc: torch.Tensor  # [] unconstrained kernel variance
    kern_len_unc: torch.Tensor  # [in_dim] unconstrained ARD lengthscales

    @property
    def var(self):
        return transforms.positive(self.var_unc)

    @property
    def kern_var(self):
        return transforms.positive(self.kern_var_unc)

    @property
    def kern_len(self):
        return transforms.positive(self.kern_len_unc)

    def to(self, *args, **kwargs) -> "SparseGPParams":
        """Every leaf through ``Tensor.to(*args, **kwargs)``."""
        return SparseGPParams(*(t.to(*args, **kwargs) for t in self.tensors()))

    def tensors(self) -> list:
        """The leaves in field order."""
        return [getattr(self, f.name) for f in fields(self)]


@dataclass
class GPCache:
    """Per-call precomputation (invariant over the time recursion)."""

    chol: torch.Tensor  # [M, M] lower Cholesky of K(Z, Z) + jitter I
    kinv: torch.Tensor  # [M, M] explicit K^-1
    kinv_diag: torch.Tensor  # [M]
    alpha: torch.Tensor  # [M, out_dim] K^-1 @ mean
    var_q: torch.Tensor  # [M, out_dim] constrained variational variance
    kern_var: torch.Tensor  # []
    kern_len: torch.Tensor  # [in_dim]
    z: torch.Tensor  # [M, in_dim]
    inv_ls: torch.Tensor  # [in_dim] 1 / lengthscales
    zs: torch.Tensor  # [M, in_dim] z * inv_ls
    kinv_alpha: torch.Tensor  # [M, M + out_dim] concat(K^-1, alpha)


def init_sparse_gp(generator: torch.Generator, in_dim: int, out_dim: int,
                   num_points: int, gp_var: float, gp_len: float,
                   zeta_mean: float, zeta_pos: float, zeta_var: float,
                   dtype=torch.float32, device=None) -> SparseGPParams:
    """The reference's distributions: z ~ U(-zeta_pos, zeta_pos),
    mean = zeta_mean * U(0, 1), constant variational variance and kernel
    hyperparameters. Draws z then mean from ``generator``, on its device
    unless ``device`` says otherwise."""
    kw = dict(dtype=dtype, device=generator.device if device is None else device)
    z = torch.rand((num_points, in_dim), generator=generator, **kw)
    z = z * (2.0 * zeta_pos) - zeta_pos
    mean = zeta_mean * torch.rand((num_points, out_dim), generator=generator, **kw)
    var_unc = torch.full(
        (num_points, out_dim), transforms.positive_inverse(zeta_var).item(), **kw
    )
    kern_var_unc = torch.tensor(transforms.positive_inverse(gp_var).item(), **kw)
    kern_len_unc = torch.full((in_dim,), transforms.positive_inverse(gp_len).item(), **kw)
    return SparseGPParams(z, mean, var_unc, kern_var_unc, kern_len_unc)


def _finish_cache(params: SparseGPParams, chol, kinv) -> GPCache:
    alpha = torch.matmul(kinv, params.mean)
    kern_len = params.kern_len
    inv_ls = 1.0 / kern_len
    return GPCache(
        chol=chol,
        kinv=kinv,
        kinv_diag=torch.diagonal(kinv),
        alpha=alpha,
        var_q=params.var,
        kern_var=params.kern_var,
        kern_len=kern_len,
        z=params.z,
        inv_ls=inv_ls,
        zs=params.z * inv_ls,
        kinv_alpha=torch.cat((kinv, alpha), dim=1),
    )


def precompute(params: SparseGPParams, jitter: float | None = None) -> GPCache:
    """Factorize K(Z, Z) once and form the solve-free predict operators."""
    gram = kernels.rbf_gram(params.z, params.kern_var, params.kern_len)
    chol = linalg.jittered_cholesky(gram, jitter)
    return _finish_cache(params, chol, linalg.cholesky_inverse(chol))


def precompute_pair(params_a: SparseGPParams, params_b: SparseGPParams,
                    jitter: float | None = None):
    """Two same-M GP caches through one batched Cholesky/inverse."""
    gram_a = kernels.rbf_gram(params_a.z, params_a.kern_var, params_a.kern_len)
    gram_b = kernels.rbf_gram(params_b.z, params_b.kern_var, params_b.kern_len)
    chol = linalg.jittered_cholesky(torch.stack((gram_a, gram_b)), jitter)
    kinv = linalg.cholesky_inverse(chol)
    return (
        _finish_cache(params_a, chol[0], kinv[0]),
        _finish_cache(params_b, chol[1], kinv[1]),
    )


def predict(cache: GPCache, xnew):
    """Predictive mean/variance at ``xnew`` [N, in_dim] -> ([N, D], [N, D]).
    ``w`` and ``mean`` come from one matmul against concat(K^-1, alpha)."""
    m = cache.kinv.shape[0]
    knm = kernels.rbf_cross(xnew, cache.z, cache.kern_var, cache.kern_len)
    wm = torch.matmul(knm, cache.kinv_alpha)
    w, fmean = wm[:, :m], wm[:, m:]
    qf = torch.sum(knm * w, dim=-1)
    # kvar - qf >= 0 mathematically; clamp the cancellation noise
    fvar = torch.clamp_min(cache.kern_var - qf, 0.0)[:, None] + torch.matmul(
        torch.square(w), cache.var_q
    )
    return fmean, fvar


def predict_rows(predict_fn, cache, gp_in, batch_axis: int):
    """Row-wise predict over an N-D input, flattened with the batch axis
    major-most (``[..., B, ..., d] -> [B*rest, d]``), as the JAX package
    does, so the rows of each step line up with it."""
    moved = torch.movedim(gp_in, batch_axis, 0)
    shape = moved.shape
    fmean, fvar = predict_fn(cache, moved.reshape(-1, shape[-1]))

    def unflatten(a):
        return torch.movedim(a.reshape(shape[:-1] + (a.shape[-1],)), 0, batch_axis)

    return unflatten(fmean), unflatten(fvar)


def predict_fast(cache: GPCache, xnew):
    """Like :func:`predict`, through the fused predict of
    :mod:`cbfssm_tpu_torch.ops.fused_predict` (the CUDA kernel on a GPU
    tensor, its plain torch version on a CPU tensor)."""
    return fused_predict(
        xnew, cache.zs, cache.inv_ls, cache.kern_var, cache.kinv, cache.alpha,
        cache.var_q,
    )


def predict_reference(params: SparseGPParams, xnew, jitter: float | None = None):
    """Triangular-solve formulation (reference gp_tf.py:132-161); the
    tests' ground truth."""
    kern_var, kern_len = params.kern_var, params.kern_len
    chol = linalg.jittered_cholesky(kernels.rbf_gram(params.z, kern_var, kern_len), jitter)
    kmn = kernels.rbf_cross(params.z, xnew, kern_var, kern_len)  # [M, N]
    a = torch.linalg.solve_triangular(chol, kmn, upper=False)
    fvar_base = torch.clamp_min(kern_var - torch.sum(torch.square(a), dim=0), 0.0)
    a = torch.linalg.solve_triangular(chol.T, a, upper=True)
    fmean = a.T @ params.mean
    fvar = fvar_base[:, None] + torch.square(a.T) @ params.var
    return fmean, fvar


def prior_kl(params: SparseGPParams, cache: GPCache):
    """KL( q(zeta) || N(0, K(Z,Z)) ) summed over output dims."""
    return kl_diag_vs_tril(
        mean_q=params.mean,
        var_q=cache.var_q,
        chol_p=cache.chol,
        kinv_p_diag=cache.kinv_diag,
        kinv_mean=cache.alpha,
    )
