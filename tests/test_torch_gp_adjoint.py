"""The port's hand-derived GP link adjoint (``ops/gp_adjoint.py``)
against the JAX package's and against torch autograd of the port's
``gp.predict`` (float64, the cases of tests/test_gp_adjoint_units.py).

Both packages read the same cache: the JAX ``GPCache`` of
tests/test_gp_adjoint_units.py's ``make_cache``, field by field.
``predict_batch`` repeats the port's predict op for op (bitwise); the
pullbacks agree at rtol 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbfssm_tpu.ops import gp_adjoint as jax_gp_adjoint
from cbfssm_tpu_torch.ops import gp, gp_adjoint
from tests.test_gp_adjoint_units import make_cache

RTOL = 1e-9
N, IN_DIM, OUT_DIM = 40, 5, 3


@pytest.fixture(scope="module")
def case():
    """(jax cache, port cache, x, d_mean, d_var) as numpy / torch."""
    _, jcache = make_cache()
    tcache = gp.GPCache(**{f.name: torch.tensor(np.asarray(getattr(jcache, f.name)))
                           for f in dataclasses.fields(gp.GPCache)})
    rng = np.random.default_rng(0)
    x, d_mean, d_var = (rng.normal(size=(N, k)) for k in (IN_DIM, OUT_DIM, OUT_DIM))
    return jcache, tcache, x, d_mean, d_var


def test_predict_batch_is_predict_bitwise(case):
    _, tcache, x, _, _ = case
    pre = gp_adjoint.predict_batch(tcache, torch.tensor(x))
    mean, var = gp.predict(tcache, torch.tensor(x))
    assert torch.equal(pre["gm0"], mean) and torch.equal(pre["gv0"], var)


@pytest.mark.parametrize("key", ["xs", "knm", "w", "gm0", "gv0", "qf", "d2pos", "rpos"])
def test_predict_batch_matches_jax(case, key):
    jcache, tcache, x, _, _ = case
    want = np.asarray(jax_gp_adjoint.predict_batch(jcache, jnp.asarray(x))[key])
    got = gp_adjoint.predict_batch(tcache, torch.tensor(x))[key].numpy()
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)


def test_link_bwd_matches_jax_and_autograd(case):
    jcache, tcache, x, d_mean, d_var = case
    xt = torch.tensor(x, requires_grad=True)
    mean, var = gp.predict(tcache, xt)
    (want,) = torch.autograd.grad((mean, var), xt, (torch.tensor(d_mean), torch.tensor(d_var)))
    pre = gp_adjoint.predict_batch(tcache, torch.tensor(x))
    got = gp_adjoint.link_bwd(tcache, pre, torch.tensor(d_mean), torch.tensor(d_var))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL)
    jpre = jax_gp_adjoint.predict_batch(jcache, jnp.asarray(x))
    jwant = jax_gp_adjoint.link_bwd(jcache, jpre, jnp.asarray(d_mean), jnp.asarray(d_var))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=RTOL)
    # a loop's hoisted zs gives the same numbers
    zs = tcache.z / tcache.kern_len
    assert torch.equal(gp_adjoint.link_bwd(tcache, pre, torch.tensor(d_mean),
                                           torch.tensor(d_var), zs=zs), got)


def test_deferred_cache_grads_match_jax_and_autograd(case):
    jcache, tcache, x, d_mean, d_var = case
    leaves = {f: getattr(tcache, f).clone().requires_grad_(True)
              for f in gp_adjoint.LINK_FIELDS}
    mean, var = gp.predict(dataclasses.replace(tcache, **leaves), torch.tensor(x))
    grads = torch.autograd.grad((mean, var), list(leaves.values()),
                                (torch.tensor(d_mean), torch.tensor(d_var)))
    pre = gp_adjoint.predict_batch(tcache, torch.tensor(x))
    got = gp_adjoint.deferred_cache_grads(tcache, pre, torch.tensor(x), torch.tensor(d_mean),
                                          torch.tensor(d_var))
    jpre = jax_gp_adjoint.predict_batch(jcache, jnp.asarray(x))
    jgot = jax_gp_adjoint.deferred_cache_grads(jcache, jpre, jnp.asarray(x),
                                               jnp.asarray(d_mean), jnp.asarray(d_var))
    for field, want in zip(gp_adjoint.LINK_FIELDS, grads):
        g = getattr(got, field)
        assert g.shape == getattr(tcache, field).shape, field
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=RTOL, atol=1e-12,
                                   err_msg=field)
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(jgot, field)), rtol=RTOL,
                                   atol=1e-12, err_msg=field)
    # the fields the predict never reads carry exact zeros
    for field in ("chol", "kinv", "kinv_diag", "alpha", "inv_ls", "zs"):
        assert torch.equal(getattr(got, field), torch.zeros_like(getattr(tcache, field))), field


def test_link_cache_predicts_like_the_full_cache(case):
    _, tcache, x, _, _ = case
    small = gp_adjoint.link_cache(*gp_adjoint.link_tensors(tcache))
    for a, b in zip(gp.predict(small, torch.tensor(x)), gp.predict(tcache, torch.tensor(x))):
        assert torch.equal(a, b)
