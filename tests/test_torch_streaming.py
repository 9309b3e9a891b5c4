"""Streaming entry points of the port's CBFSSMHALF (``filter_ops`` /
``filter_init`` / ``filter_step`` / ``forecast``) and
``BaseSSM.filter_replay``, against the port's own rollout and the JAX
package's (CPU, float64, tests/test_streaming.py's setup).

The JAX ``forecast`` draws ``normal(key, (H, B, S, 1))`` and the JAX
``filter_replay`` draws step i from ``fold_in(base_key, t0 + i)``; the
port takes those arrays as ``eps=``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbfssm_tpu.models import CBFSSMHALF as JaxCBFSSMHALF
from cbfssm_tpu_torch.convert import cbfssmhalf_params_from_numpy
from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF, PRSSM
from tests.test_other_models import half_config, prssm_config
from tests.test_torch_other_models import params_numpy

RTOL = 1e-10


@pytest.fixture(scope="module")
def setup():
    jm = JaxCBFSSMHALF(half_config("rnn"))
    params = jm.init(jax.random.PRNGKey(0))
    pm = CBFSSMHALF(half_config("rnn"), device="cpu")
    rng = np.random.default_rng(0)
    u, y = rng.normal(size=(2, 8, 2)), rng.normal(size=(2, 8, 1))
    return jm, params, pm, cbfssmhalf_params_from_numpy(params_numpy(params), device="cpu"), u, y


def normal(key, shape):
    return np.asarray(jax.random.normal(key, shape + (1,), dtype=jnp.float64))


def test_filter_step_reproduces_rollout(setup):
    """tests/test_streaming.py::test_filter_step_reproduces_rollout for
    the port: fed the rollout's own draws, filter_step reproduces it."""
    _, _, pm, tparams, u, y = setup
    eps = pm.draw_noise(torch.Generator().manual_seed(3), 8, 2)
    x_final, _, _ = pm._rollout(tparams, u, y, condition=True, noise=eps)
    ops = pm.filter_ops(tparams)
    u_tm, y_tm = pm._time_major(u), pm._time_major(y)
    x = pm.filter_init(tparams, u, y)
    torch.testing.assert_close(x, x_final[0], rtol=0, atol=0)
    for t in range(7):
        x, (mean, var) = pm.filter_step(tparams, ops, x, u_tm[t], y_tm[t + 1], eps=eps[t])
        torch.testing.assert_close(x, x_final[t + 1], rtol=1e-12, atol=1e-13)
        x = x_final[t + 1]
        assert tuple(mean.shape) == (2, 1) and float(var.min()) > 0


def test_forecast_matches_jax_and_is_pure(setup):
    jm, params, pm, tparams, u, y = setup
    key = jax.random.PRNGKey(5)
    u_future = np.random.default_rng(1).normal(size=(2, 6, 2))

    def reference(p):
        x0 = jm.filter_init(p, u, y)
        return x0, jm.forecast(p, jm.filter_ops(p), x0, u_future, key)

    jx, want = jax.jit(reference)(params)
    x = pm.filter_init(tparams, u, y)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL)
    eps = torch.tensor(normal(key, (6, 2, pm.samples)))
    x_before = x.clone()
    got = pm.forecast(tparams, pm.filter_ops(tparams), x, u_future, eps=eps)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 6, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-14)
    assert torch.equal(x, x_before)
    again = pm.forecast(tparams, pm.filter_ops(tparams), x, u_future,
                        torch.Generator().manual_seed(0))
    assert torch.isfinite(again[0]).all()


@pytest.mark.parametrize("active", [None, [True, True, False, True],
                                    [[True, False], [True, True], [False, True], [True, False]]])
def test_filter_replay_matches_jax(setup, active):
    jm, params, pm, tparams, u, y = setup
    base_key, t0, k_len = jax.random.PRNGKey(9), 3, 4
    x0 = pm.filter_init(tparams, u, y).numpy()  # equal to JAX's (the forecast test)
    u_blk, y_blk = u[:, 3:3 + k_len], y[:, 4:4 + k_len]
    act = None if active is None else np.asarray(active)
    want_x, (want_m, want_v) = jax.jit(lambda p: jm.filter_replay(
        p, jm.filter_ops(p), jnp.asarray(x0), u_blk, y_blk, base_key, t0, active=act))(params)
    eps = torch.tensor(np.stack([normal(jax.random.fold_in(base_key, t0 + i), (2, pm.samples))
                                 for i in range(k_len)]))
    got_x, (got_m, got_v) = pm.filter_replay(tparams, pm.filter_ops(tparams), torch.tensor(x0),
                                             u_blk, y_blk, active=act, eps=eps)
    for g, w in ((got_x, want_x), (got_m, want_m), (got_v, want_v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-14)
    assert tuple(got_m.shape) == (2, k_len, 1)


def test_filter_replay_checks(setup):
    _, _, pm, tparams, u, y = setup
    ops = pm.filter_ops(tparams)
    x = pm.filter_init(tparams, u, y)
    with pytest.raises(ValueError, match=r"active must be \[3\] or \[3, 2\]"):
        pm.filter_replay(tparams, ops, x, u[:, :3], y[:, :3], torch.Generator(),
                         active=np.ones((2, 3), bool))
    with pytest.raises(ValueError, match="eps must be"):
        pm.filter_replay(tparams, ops, x, u[:, :3], y[:, :3], eps=torch.zeros(3, 2, 1, 1))
    with pytest.raises(ValueError, match="generator"):
        pm.filter_replay(tparams, ops, x, u[:, :3], y[:, :3])
    x_fin, (mean, _) = pm.filter_replay(tparams, ops, x, u[:, :3], y[:, :3],
                                        torch.Generator().manual_seed(0))
    assert torch.isfinite(x_fin).all() and tuple(mean.shape) == (2, 3, 1)
    held, _ = pm.filter_replay(tparams, ops, x, u[:, :3], y[:, :3],
                               torch.Generator().manual_seed(0), active=[False] * 3)
    assert torch.equal(held, x)
    for model in (PRSSM(prssm_config(), device="cpu"),
                  CBFSSM(dict(half_config(), var_y=np.asarray([0.5] * 3)), device="cpu")):
        with pytest.raises(TypeError, match="filter_step"):
            model.filter_replay(None, None, x, u, y)
