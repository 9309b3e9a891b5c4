"""The PyTorch port's math core against ``cbfssm_tpu.ops`` (float64).

Inputs are made with numpy from a seed and run through the JAX function
and its port counterpart; results agree to rtol 1e-10 (both run the
same float64 formulas; only summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbfssm_tpu.ops import distributions as jdist
from cbfssm_tpu.ops import gp as jgp
from cbfssm_tpu.ops import kernels as jkern
from cbfssm_tpu.ops import linalg as jlinalg
from cbfssm_tpu.ops import transforms as jtrans
from cbfssm_tpu_torch.ops import distributions, gp, kernels, linalg, transforms
from tests.test_gp import make_gp

RTOL = 1e-10


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol,
    )


def port_gp(params):
    """A JAX SparseGPParams as the port's (numpy leaves, float64)."""
    return gp.SparseGPParams(*(t(getattr(params, k)) for k in (
        "z", "mean", "var_unc", "kern_var_unc", "kern_len_unc")))


# --- transforms ----------------------------------------------------------


@pytest.mark.parametrize("scale", [0.1, 3.0, 50.0])
def test_positive_matches(rng, scale):
    x = rng.normal(size=(7, 3)) * scale
    close(transforms.positive(t(x)), jtrans.positive(jnp.asarray(x)))


def test_positive_inverse_array_equal_and_guarded():
    y = np.asarray([1e-8, 1e-4, 0.5, 2.0, 34.0, 36.0, 1e3])
    np.testing.assert_array_equal(transforms.positive_inverse(y), jtrans.positive_inverse(y))
    close(transforms.positive(t(transforms.positive_inverse(y))), y, rtol=1e-12)
    with pytest.raises(ValueError):
        transforms.positive_inverse([0.0])


# --- kernels ---------------------------------------------------------------


@pytest.mark.parametrize("fn", ["scaled_square_dist", "rbf_cross"])
def test_kernels_match(rng, fn):
    x, z = rng.normal(size=(9, 4)), rng.normal(size=(6, 4))
    ls = rng.uniform(0.5, 2.0, size=4)
    args = (t(x), t(z), t(ls)) if fn == "scaled_square_dist" else (t(x), t(z), t(0.7), t(ls))
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    close(getattr(kernels, fn)(*args), getattr(jkern, fn)(*jargs), atol=1e-14)


def test_rbf_gram_matches_and_clamps(rng):
    z = rng.normal(size=(8, 3)) * 50.0  # large norms: cancellation on the diagonal
    ls = rng.uniform(0.5, 2.0, size=3)
    got = kernels.rbf_gram(t(z), t(0.3), t(ls))
    close(got, jkern.rbf_gram(jnp.asarray(z), 0.3, jnp.asarray(ls)), atol=1e-14)
    assert (kernels.scaled_square_dist(t(z), t(z), t(ls)) >= 0).all()


@pytest.mark.parametrize("n, variance", [(6, 2.5), (1, 0.3)])
def test_rbf_diag_matches(n, variance):
    """tests/test_kernels.py::test_diag's case and a one-point one."""
    got = kernels.rbf_diag(n, variance, torch.float64)
    assert tuple(got.shape) == (n,) and got.dtype == torch.float64
    close(got, jkern.rbf_diag(n, variance, jnp.float64), rtol=1e-12)


# --- linalg ----------------------------------------------------------------


def spd(rng, m, batch=()):
    a = rng.normal(size=batch + (m, m))
    return a @ np.swapaxes(a, -1, -2) + m * np.eye(m)


def test_default_jitter():
    assert linalg.default_jitter(torch.float64) == jlinalg.default_jitter(jnp.float64)
    assert linalg.default_jitter(torch.float32) == jlinalg.default_jitter(jnp.float32)


@pytest.mark.parametrize("batch", [(), (2,)])
def test_jittered_cholesky_and_inverse(rng, batch):
    k = spd(rng, 6, batch)
    chol = linalg.jittered_cholesky(t(k), 1e-8)
    jchol = jlinalg.jittered_cholesky(jnp.asarray(k), 1e-8)
    close(chol, jchol, atol=1e-14)
    close(linalg.cholesky_inverse(chol), jlinalg.cholesky_inverse(jchol), atol=1e-14)
    close(linalg.log_det_from_chol(chol), jlinalg.log_det_from_chol(jchol))


def test_jittered_cholesky_not_positive_definite_is_nan_like_jax(rng):
    """A factor that does not exist is NaN on and below the diagonal, as
    ``jnp.linalg.cholesky`` gives, and only in that batch member (no
    exception: reading the factorization's status back would be a host
    sync on the card)."""
    bad = np.asarray([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    k = np.stack([bad, spd(rng, 3)])
    chol = linalg.jittered_cholesky(t(k), 1e-8).numpy()
    jchol = np.asarray(jlinalg.jittered_cholesky(jnp.asarray(k), 1e-8))
    np.testing.assert_array_equal(np.isnan(chol), np.isnan(jchol))
    assert np.isnan(chol[0][np.tril_indices(3)]).all() and not np.isnan(chol[1]).any()
    np.testing.assert_array_equal(chol[0][np.triu_indices(3, 1)], jchol[0][np.triu_indices(3, 1)])
    close(chol[1], jchol[1], atol=1e-14)


@pytest.mark.parametrize("rhs", [(9, 3), (9, 1)])
def test_cho_solve_matches(rng, rhs):
    """tests/test_linalg.py::test_cho_solve's case: K x = b solved from the
    lower Cholesky factor, against the JAX function and against K."""
    k = spd(rng, 9)
    b = rng.normal(size=rhs)
    chol = np.linalg.cholesky(k)
    got = linalg.cho_solve(t(chol), t(b))
    close(got, jlinalg.cho_solve(jnp.asarray(chol), jnp.asarray(b)), rtol=1e-12)
    close(t(k) @ got, b, rtol=1e-8, atol=1e-10)


def test_jittered_cholesky_float32_factorizes_in_float64(rng):
    """float32 input: factorized in float64 with the float32 jitter and
    cast back, as the JAX package does under x64."""
    k = spd(rng, 5).astype(np.float32)
    chol = linalg.jittered_cholesky(torch.tensor(k))
    assert chol.dtype == torch.float32
    want = jlinalg.jittered_cholesky(jnp.asarray(k))
    assert want.dtype == jnp.float32
    np.testing.assert_array_equal(chol.numpy(), np.asarray(want))


# --- distributions ---------------------------------------------------------


def test_diag_gaussian_logpdf(rng):
    x, m = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    v = rng.uniform(0.1, 2.0, size=3)
    close(distributions.diag_gaussian_logpdf(t(x), t(m), t(v)),
          jdist.diag_gaussian_logpdf(jnp.asarray(x), jnp.asarray(m), jnp.asarray(v)))


@pytest.mark.parametrize("shape, axis", [((5, 2), -1), ((7,), -1), ((3, 4), 0)])
def test_diag_gaussian_entropy_matches(rng, shape, axis):
    """tests/test_distributions.py's entropy cases (var [5, 2] by row, a
    [7] vector) and a sum over axis 0."""
    var = rng.uniform(0.01, 3.0, size=shape)
    close(distributions.diag_gaussian_entropy(t(var), axis=axis),
          jdist.diag_gaussian_entropy(jnp.asarray(var), axis=axis), rtol=1e-12)


@pytest.mark.parametrize("axis", [-1, (1, 2)])
def test_kl_diag_gaussians(rng, axis):
    mq, mp = rng.normal(size=(2, 3, 4)), rng.normal(size=(2, 3, 4))
    vq, vp = rng.uniform(0.1, 2.0, size=(2, 2, 3, 4))
    got = distributions.kl_diag_gaussians(t(mq), t(vq), t(mp), t(vp), axis=axis)
    want = jdist.kl_diag_gaussians(*(jnp.asarray(a) for a in (mq, vq, mp, vp)), axis=axis)
    close(got, want)


def test_kl_diag_vs_tril(rng):
    k = spd(rng, 5)
    chol = np.linalg.cholesky(k)
    kinv = np.linalg.inv(k)
    mean, var = rng.normal(size=(5, 2)), rng.uniform(0.1, 1.0, size=(5, 2))
    args = (mean, var, chol, np.diag(kinv), kinv @ mean)
    close(distributions.kl_diag_vs_tril(*(t(a) for a in args)),
          jdist.kl_diag_vs_tril(*(jnp.asarray(a) for a in args)))


# --- sparse GP ------------------------------------------------------------


def test_init_sparse_gp_distributions():
    g = torch.Generator().manual_seed(3)
    p = gp.init_sparse_gp(g, 4, 2, 50, gp_var=0.25, gp_len=1.5, zeta_mean=0.01,
                          zeta_pos=2.0, zeta_var=1e-4, dtype=torch.float64)
    assert p.z.shape == (50, 4) and p.mean.shape == (50, 2)
    assert (p.z.abs() <= 2.0).all() and p.z.std() > 0.5
    assert ((p.mean >= 0) & (p.mean <= 0.01)).all()
    close(p.var, np.full((50, 2), 1e-4), rtol=1e-12)
    close(p.kern_var, 0.25, rtol=1e-12)
    close(p.kern_len, np.full(4, 1.5), rtol=1e-12)
    again = gp.init_sparse_gp(torch.Generator().manual_seed(3), 4, 2, 50, 0.25, 1.5,
                              0.01, 2.0, 1e-4, dtype=torch.float64)
    assert torch.equal(p.z, again.z) and torch.equal(p.mean, again.mean)


def test_precompute_pair_matches():
    pa, pb = make_gp(0), make_gp(1)
    ja, jb = jgp.precompute_pair(pa, pb, jitter=1e-8)
    ta, tb = gp.precompute_pair(port_gp(pa), port_gp(pb), jitter=1e-8)
    for got, want in ((ta, ja), (tb, jb)):
        for name in ("chol", "kinv", "kinv_diag", "alpha", "var_q", "kern_var",
                     "kern_len", "z", "inv_ls", "zs", "kinv_alpha"):
            close(getattr(got, name), getattr(want, name), atol=1e-12)


def test_precompute_equals_pair():
    pa, pb = port_gp(make_gp(0)), port_gp(make_gp(1))
    single = gp.precompute(pb, 1e-8)
    _, pair = gp.precompute_pair(pa, pb, 1e-8)
    close(pair.kinv, single.kinv.numpy(), atol=1e-12)


@pytest.mark.parametrize("fn", ["predict", "predict_fast"])
def test_predict_matches(rng, fn):
    params = make_gp()
    xnew = rng.normal(size=(40, 3))
    want = jgp.predict(jgp.precompute(params, jitter=1e-8), jnp.asarray(xnew))
    got = getattr(gp, fn)(gp.precompute(port_gp(params), 1e-8), t(xnew))
    for g, w in zip(got, want):
        close(g, w, atol=1e-12)


def test_predict_reference_matches(rng):
    params = make_gp()
    xnew = rng.normal(size=(12, 3))
    want = jgp.predict_reference(params, jnp.asarray(xnew), jitter=1e-8)
    got = gp.predict_reference(port_gp(params), t(xnew), jitter=1e-8)
    for g, w in zip(got, want):
        close(g, w, atol=1e-12)
    # and the solve-free path agrees with the triangular-solve one
    fast = gp.predict(gp.precompute(port_gp(params), 1e-8), t(xnew))
    for g, w in zip(fast, got):
        close(g, w.numpy(), rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("shape,axis", [((2, 3, 4), 1), ((2, 2, 3, 4), 2), ((3, 4), 0)])
def test_predict_rows_matches(rng, shape, axis):
    params = make_gp()
    gp_in = rng.normal(size=shape + (3,))
    want = jgp.predict_rows(jgp.predict, jgp.precompute(params, 1e-8), jnp.asarray(gp_in), axis)
    got = gp.predict_rows(gp.predict, gp.precompute(port_gp(params), 1e-8), t(gp_in), axis)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w, atol=1e-12)


def test_prior_kl_matches():
    params = make_gp()
    want = jgp.prior_kl(params, jgp.precompute(params, jitter=1e-8))
    tp = port_gp(params)
    close(gp.prior_kl(tp, gp.precompute(tp, 1e-8)), want)


def test_params_to_dtype():
    p = port_gp(make_gp()).to(torch.float32)
    assert all(getattr(p, k).dtype == torch.float32 for k in ("z", "mean", "kern_var_unc"))

