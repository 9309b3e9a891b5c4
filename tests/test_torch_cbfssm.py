"""The port's CBFSSM against ``cbfssm_tpu.models.CBFSSM`` (float64).

Both packages get the same parameters (the JAX pytree's leaves through
``cbfssm_tpu_torch.convert``) and the same random numbers: the arrays
the JAX model draws inside its rollout are reproduced here with its key
schedule (split into kb, kf; kb into the recognition resample and
transition keys; ``_shared_eps`` shapes) and handed to the port as
``noise=``. Loss, every aux entry and predict agree at rtol 1e-7, the
golden tolerance of tests/test_cbfssm_model.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbfssm_tpu.models import segmentation as jseg
from cbfssm_tpu_torch.convert import GP_LEAVES, cbfssm_params_from_numpy
from cbfssm_tpu_torch.models import CBFSSM, segmentation
from cbfssm_tpu_torch.models.cbfssm import RolloutNoise
from tests.test_cbfssm_model import make_model

RTOL = 1e-7


def port_config(jax_model, **overrides):
    cfg = {f.name: getattr(jax_model.config, f.name)
           for f in dataclasses.fields(jax_model.config) if f.name != "extra"}
    cfg.update(overrides)
    return cfg


def params_numpy(params):
    """The JAX CBFSSMParams flattened to the nested numpy dict that
    convert.cbfssm_params_from_numpy takes."""
    def gp_leaves(g):
        return {k: np.asarray(getattr(g, k)) for k in GP_LEAVES}

    return {"gp_f": gp_leaves(params.gp_f), "gp_b": gp_leaves(params.gp_b),
            "var_x_unc": np.asarray(params.var_x_unc),
            "var_y_unc": np.asarray(params.var_y_unc)}


def jax_noise(port_model, key, t_len, b):
    """The JAX rollout's draws for ``key`` (cbfssm.py:139-141, 202-204,
    287, 321; base.py:180-184)."""
    s = port_model.samples
    kb, kf = jax.random.split(key)
    k_noise, k_eps = jax.random.split(kb)
    t_b = t_len
    if port_model.backward_schedule(t_len) == "blocked":
        t_b = jseg.blocked_layout(t_len, port_model.config.recog_len)[0]

    def draw(k, shape):
        return torch.tensor(np.asarray(jax.random.normal(k, shape + (1,), dtype=jnp.float64)))

    return RolloutNoise(draw(k_noise, (t_b, 2, b, s)), draw(k_eps, (t_b, 2, b, s)),
                        draw(kf, (t_len - 1, b, s)))


def pair(seq_len=8, recog_len=2, backward_mode="sequential", **overrides):
    jm = make_model(seq_len=seq_len, recog_len=recog_len, backward_mode=backward_mode)
    return jm, CBFSSM(port_config(jm, **overrides), device="cpu")


def batch(seq_len=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, seq_len, 2)), rng.normal(size=(2, seq_len, 1))


def assert_loss_parity(jm, pm, u, y, key, condition=True, weights=None, param_seed=0):
    params = jm.init(jax.random.PRNGKey(param_seed))
    want, want_aux = jm.loss(params, u, y, key, condition=condition,
                             weights=None if weights is None else jnp.asarray(weights))
    got, got_aux = pm.loss(cbfssm_params_from_numpy(params_numpy(params), device="cpu"), u, y,
                           condition=condition, weights=weights,
                           noise=jax_noise(pm, key, u.shape[1], u.shape[0]))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert set(got_aux) == set(want_aux)
    for name in want_aux:
        np.testing.assert_allclose(float(got_aux[name]), float(want_aux[name]), rtol=RTOL,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("mode", ["sequential", "blocked"])
@pytest.mark.parametrize("condition", [True, False])
def test_loss_and_aux_match_jax(mode, condition):
    jm, pm = pair(backward_mode=mode)
    u, y = batch()
    assert_loss_parity(jm, pm, u, y, jax.random.PRNGKey(42), condition=condition)


@pytest.mark.parametrize("seq_len,recog_len", [(7, 2), (16, 4), (9, 3), (12, 16), (34, 16)])
def test_blocked_loss_matches_jax_across_shapes(seq_len, recog_len):
    """Odd lengths, partial top blocks, and T < 2L (single block)."""
    jm, pm = pair(seq_len, recog_len, "blocked")
    u, y = batch(seq_len, seed=seq_len)
    assert_loss_parity(jm, pm, u, y, jax.random.PRNGKey(5), param_seed=1)


def test_auto_mode_matches_jax():
    jm, pm = pair(backward_mode="auto")
    assert pm.backward_schedule(8) == "blocked" and pm.backward_schedule(4) == "sequential"
    u, y = batch()
    assert_loss_parity(jm, pm, u, y, jax.random.PRNGKey(9))


def test_padded_weights_match_jax_and_ignore_pad_content():
    jm, pm = pair()
    u, y = batch()
    w = np.asarray([1.0, 0.0])
    assert_loss_parity(jm, pm, u, y, jax.random.PRNGKey(5), weights=w)
    params = cbfssm_params_from_numpy(params_numpy(jm.init(jax.random.PRNGKey(0))), device="cpu")
    noise = jax_noise(pm, jax.random.PRNGKey(5), 8, 2)
    u2, y2 = u.copy(), y.copy()
    u2[1] *= 100.0
    y2[1] *= -100.0
    l1, _ = pm.loss(params, u, y, weights=w, noise=noise)
    l2, _ = pm.loss(params, u2, y2, weights=w, noise=noise)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-10)


@pytest.mark.parametrize("mode", ["sequential", "blocked"])
@pytest.mark.parametrize("condition", [False, True])
def test_predict_matches_jax(mode, condition):
    jm, pm = pair(backward_mode=mode)
    u, y = batch(seed=3)
    params = jm.init(jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(7)
    want = jm.predict(params, u, y, key, condition=condition)
    got = pm.predict(cbfssm_params_from_numpy(params_numpy(params), device="cpu"), u, y,
                     condition=condition, noise=jax_noise(pm, key, 8, 2))
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)),
                                   rtol=RTOL, atol=1e-12, err_msg=f.name)


@pytest.mark.parametrize("mode", ["sequential", "blocked"])
def test_gp_impl_pallas_on_cpu_equals_solve_free(mode):
    jm, plain = pair(backward_mode=mode)
    _, fused = pair(backward_mode=mode, gp_impl="pallas")
    params = cbfssm_params_from_numpy(params_numpy(jm.init(jax.random.PRNGKey(0))), device="cpu")
    u, y = batch()
    noise = jax_noise(plain, jax.random.PRNGKey(11), 8, 2)
    l1, _ = plain.loss(params, u, y, noise=noise)
    l2, _ = fused.loss(params, u, y, noise=noise)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-10)


def test_generator_draws_are_deterministic_and_shaped():
    jm, pm = pair(backward_mode="blocked")
    params = pm.init(torch.Generator().manual_seed(0))
    u, y = batch()
    noise = pm.draw_noise(torch.Generator().manual_seed(1), 8, 2)
    assert tuple(noise.backward_noise.shape) == (12, 2, 2, 3, 1)  # t_ext = 12 at T=8, L=2
    assert tuple(noise.forward_eps.shape) == (7, 2, 3, 1)
    l1, _ = pm.loss(params, u, y, torch.Generator().manual_seed(1))
    l2, _ = pm.loss(params, u, y, noise=noise)
    l3, _ = pm.loss(params, u, y, torch.Generator().manual_seed(2))
    assert torch.isfinite(l1) and float(l1) == float(l2) != float(l3)
    with pytest.raises(ValueError, match="generator"):
        pm.loss(params, u, y)


def test_init_shapes_and_var_dict():
    _, pm = pair()
    p = pm.init(torch.Generator().manual_seed(0))
    assert tuple(p.gp_f.z.shape) == (5, 5) and tuple(p.gp_f.mean.shape) == (5, 3)
    assert tuple(p.gp_b.mean.shape) == (5, 2)  # dim_h = dim_x - dim_y
    assert p.gp_f.z.dtype == torch.float64
    np.testing.assert_allclose(pm.var_dict(p)["process noise"].numpy(), 0.01, rtol=1e-10)
    assert len(pm.var_dict(p)) == 12
    p32 = p.to(torch.float32)
    assert p32.gp_b.kern_len_unc.dtype == torch.float32


@pytest.mark.parametrize("override,match", [
    ({"gp_impl": "triton"}, "gp_impl"),
    ({"adjoint": "hand", "gp_impl": "pallas"}, "requires gp_impl='solve_free'"),
    ({"adjoint": "parallel"}, "does not implement"),
    ({"adjoint": "sideways"}, "adjoint must be"),
    ({"epochs_per_dispatch": "fast"}, "epochs_per_dispatch"),
    ({"backward_mode": "Blocked"}, "backward_mode"),
    ({"gp_matmul_precision": "default"}, "not ported"),
    ({"scan_unroll": 0}, "scan_unroll"),
    ({"dtype": "bfloat16"}, "dtype"),
    ({"var_x": np.asarray([0.1, 0.1])}, "var_x"),
    ({"dim_x": 0}, "dim_x"),
])
def test_config_checks_raise(override, match):
    with pytest.raises(ValueError, match=match):
        pair(**override)


@pytest.mark.parametrize("seq_len,recog_len", [(8, 2), (7, 2), (300, 50), (12, 16), (1, 1)])
def test_segmentation_array_equal(seq_len, recog_len):
    for got, want in zip(segmentation.backward_masks(seq_len, recog_len),
                         jseg.backward_masks(seq_len, recog_len)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(segmentation.forward_condition_mask(seq_len, recog_len),
                                  jseg.forward_condition_mask(seq_len, recog_len))
    assert segmentation.blocked_layout(seq_len, recog_len) == jseg.blocked_layout(seq_len, recog_len)


def test_convert_places_and_checks():
    jm, _ = pair()
    tree = params_numpy(jm.init(jax.random.PRNGKey(0)))
    p = cbfssm_params_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert p.gp_f.z.dtype == torch.float32 and p.var_y_unc.device.type == "cpu"
    np.testing.assert_array_equal(p.gp_b.mean.numpy(), tree["gp_b"]["mean"].astype(np.float32))
    del tree["gp_f"]["kern_len_unc"]
    with pytest.raises(KeyError, match="kern_len_unc"):
        cbfssm_params_from_numpy(tree, device="cpu")
