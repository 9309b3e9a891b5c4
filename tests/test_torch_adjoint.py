"""The port's hand adjoint (``adjoint='hand'``, models/adjoint.py) and the
Voliro parallel adjoint (``adjoint='parallel'``) against the JAX
package's, and the adjoint rules of ``BaseSSM`` (CPU).

The cases of tests/test_adjoint.py: for both recognition schedules and
both ``condition`` values the hand loss equals the port's autodiff loss
bitwise and its gradients (parameters and data) equal the JAX hand
gradients at rtol 1e-7 (float64); ``dim_h == 0``; 2 lanes under
``MultiSeedTrainer`` against JAX's vmapped hand gradients; float32
(bitwise primal, gradients at rtol 2e-3 / atol 1e-5); four Adam steps
that track autodiff at rtol 1e-6. Voliro's parallel gradients equal the
JAX package's at rtol 1e-7 / atol 1e-11 (tests/test_other_models.py).
Both packages get the same parameters (``convert``) and draws
(``jax_noise``); each JAX reference is jitted once per module.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbfssm_tpu import model_store as jax_store
from cbfssm_tpu.models import Voliro as JaxVoliro
from cbfssm_tpu_torch import convert, model_store
from cbfssm_tpu_torch.convert import cbfssm_params_from_numpy, cbfssm_params_to_numpy
from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF, PRSSM, Voliro, adjoint
from cbfssm_tpu_torch.ops import parallel_vjp
from cbfssm_tpu_torch.training import MultiSeedTrainer, Trainer
from tests.test_adjoint import make_model as jax_model
from tests.test_other_models import half_config, prssm_config, voliro_batch, voliro_config
from tests.test_torch_cbfssm import jax_noise, params_numpy, port_config
from tests.test_torch_lanes import one_thread  # noqa: F401 (autouse)
from tests.test_torch_voliro import jax_noise as voliro_noise
from tests.test_torch_voliro import params_numpy as voliro_params_numpy
from tests.test_trainer import SmokeDS, smoke_config

RTOL = 1e-7
T_LEN, B = 12, 2
WEIGHTS = np.asarray([1.0, 0.5])


def data(dim_y=1):
    rng = np.random.default_rng(0)
    return rng.normal(size=(B, T_LEN, 2)), rng.normal(size=(B, T_LEN, dim_y))


def port_model(jm, mode, **overrides):
    return CBFSSM(port_config(jm, adjoint=mode, **overrides), device="cpu")


@pytest.fixture
def backward_calls(monkeypatch):
    """Counts the backward calls of the hand and parallel Functions, so a
    test sees that the schedule it asked for ran."""
    calls = {"forward_scan": 0, "backward_scan": 0, "scan_outputs": 0}
    for name, cls in (("forward_scan", adjoint.ForwardScan),
                      ("backward_scan", adjoint.BackwardScan),
                      ("scan_outputs", parallel_vjp.ScanOutputs)):
        def counted(ctx, *grads, _orig=cls.backward, _name=name):
            calls[_name] += 1
            return _orig(ctx, *grads)

        monkeypatch.setattr(cls, "backward", staticmethod(counted))
    return calls


def port_loss_and_grads(pm, jparams, u, y, noise, condition=True, weights=WEIGHTS,
                        dtype=torch.float64):
    """(loss, param grads as the JAX numpy tree, d_u, d_y)."""
    tparams = cbfssm_params_from_numpy(params_numpy(jparams), device="cpu", dtype=dtype)
    leaves = [t.clone().requires_grad_(True) for t in tparams.tensors()]
    uu = torch.tensor(u, dtype=dtype, requires_grad=True)
    yy = torch.tensor(y, dtype=dtype, requires_grad=True)
    loss, _ = pm.loss(tparams.with_tensors(leaves), uu, yy, condition=condition,
                      weights=weights, noise=noise)
    grads = torch.autograd.grad(loss, leaves + [uu, yy])
    tree = cbfssm_params_to_numpy(tparams.with_tensors(grads[:-2]))
    return loss.detach(), tree, grads[-2].numpy(), grads[-1].numpy()


def assert_tree_close(got, want, rtol, atol):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(flat_got) == set(flat_want)
    for path, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(flat_got[path]), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_hand():
    """The JAX hand loss and gradients (params, u, y) per case, jitted
    once: (jax model, params, loss, grads)."""
    cache = {}

    def get(backward_mode="blocked", condition=True, dim_x=3):
        key_ = (backward_mode, condition, dim_x)
        if key_ not in cache:
            jm = jax_model("hand", backward_mode=backward_mode, dim_x=dim_x)
            params = jm.init(jax.random.PRNGKey(0))
            key = jax.random.PRNGKey(1)
            u, y = data()
            f = jax.jit(jax.value_and_grad(
                lambda p, uu, yy: jm.loss(p, uu, yy, key, condition, jnp.asarray(WEIGHTS))[0],
                argnums=(0, 1, 2)))
            loss, grads = f(params, jnp.asarray(u), jnp.asarray(y))
            cache[key_] = (jm, params, float(loss), grads)
        return cache[key_]

    return get


@pytest.mark.parametrize("backward_mode", ["sequential", "blocked"])
@pytest.mark.parametrize("condition", [True, False])
def test_hand_matches_autodiff_and_jax(jax_hand, backward_calls, backward_mode, condition):
    jm, params, want_loss, (g_p, g_u, g_y) = jax_hand(backward_mode, condition)
    u, y = data()
    hand, auto = port_model(jm, "hand"), port_model(jm, "autodiff")
    noise = jax_noise(hand, jax.random.PRNGKey(1), T_LEN, B)
    l_hand, t_hand, du, dy = port_loss_and_grads(hand, params, u, y, noise, condition)
    assert backward_calls["forward_scan"] == 1
    # the blocked recognition is hand; the sequential one stays autograd
    assert backward_calls["backward_scan"] == (backward_mode == "blocked")
    l_auto, *_ = port_loss_and_grads(auto, params, u, y, noise, condition)
    assert float(l_hand) == float(l_auto)  # same step bodies: bitwise
    np.testing.assert_allclose(float(l_hand), want_loss, rtol=RTOL)
    assert_tree_close(t_hand, params_numpy(g_p), RTOL, 1e-12)
    np.testing.assert_allclose(du, np.asarray(g_u), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(dy, np.asarray(g_y), rtol=RTOL, atol=1e-12)


def test_hand_no_hidden_dims(jax_hand, backward_calls):
    """dim_h == 0: the recognition GP has no outputs; the forward
    rollout is still hand."""
    jm, params, want_loss, (g_p, _, _) = jax_hand("blocked", True, dim_x=1)
    u, y = data()
    hand, auto = port_model(jm, "hand"), port_model(jm, "autodiff")
    noise = jax_noise(hand, jax.random.PRNGKey(1), T_LEN, B)
    l_hand, t_hand, _, _ = port_loss_and_grads(hand, params, u, y, noise)
    assert backward_calls["forward_scan"] == 1
    l_auto, t_auto, _, _ = port_loss_and_grads(auto, params, u, y, noise)
    assert float(l_hand) == float(l_auto)
    np.testing.assert_allclose(float(l_hand), want_loss, rtol=RTOL)
    assert_tree_close(t_hand, params_numpy(g_p), RTOL, 1e-12)


def test_hand_lanes_under_multiseed_match_jax_vmap(tmp_path, backward_calls):
    """2 lanes through ``MultiSeedTrainer.lane_losses`` (torch.func.vmap
    over the loss) against ``jax.vmap(jax.grad)`` of the JAX hand loss."""
    jm = jax_model("hand")
    u, y = data()
    ps = [jm.init(jax.random.PRNGKey(i)) for i in range(2)]
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ps)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    want = jax.jit(jax.vmap(jax.grad(
        lambda p, k: jm.loss(p, jnp.asarray(u), jnp.asarray(y), k, True)[0])))(stacked, keys)
    pm = port_model(jm, "hand")
    trainer = MultiSeedTrainer(pm, str(tmp_path / "ms"), n_seeds=2)
    tparams = cbfssm_params_from_numpy(convert.stack([params_numpy(p) for p in ps]),
                                       device="cpu")
    leaves = [t.clone().requires_grad_(True) for t in tparams.tensors()]
    losses = trainer.lane_losses(tparams.with_tensors(leaves), torch.tensor(u), torch.tensor(y),
                                 torch.ones(B, dtype=torch.float64),
                                 [jax_noise(pm, k, T_LEN, B) for k in keys], lanes_data=False)
    grads = torch.autograd.grad(losses.sum(), leaves)
    assert backward_calls["forward_scan"] >= 1 and backward_calls["backward_scan"] >= 1
    assert_tree_close(cbfssm_params_to_numpy(tparams.with_tensors(grads)),
                      params_numpy(want), RTOL, 1e-12)


def test_float32_primal_bitwise_and_grads_close():
    jm = jax_model("hand", dtype="float32")
    params = jm.init(jax.random.PRNGKey(0))
    u, y = data()
    hand, auto = port_model(jm, "hand"), port_model(jm, "autodiff")
    noise = jax_noise(hand, jax.random.PRNGKey(1), T_LEN, B)
    noise = dataclasses.replace(noise, **{f.name: getattr(noise, f.name).float()
                                          for f in dataclasses.fields(noise)})
    kw = dict(dtype=torch.float32, weights=None)
    l_hand, t_hand, du_h, dy_h = port_loss_and_grads(hand, params, u, y, noise, **kw)
    l_auto, t_auto, du_a, dy_a = port_loss_and_grads(auto, params, u, y, noise, **kw)
    assert l_hand.dtype == torch.float32 and float(l_hand) == float(l_auto)
    assert_tree_close(t_hand, t_auto, 2e-3, 1e-5)
    np.testing.assert_allclose(du_h, du_a, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(dy_h, dy_a, rtol=2e-3, atol=1e-5)


def test_adam_steps_track_autodiff():
    """Four Adam steps (lr 0.05) on one batch: the hand losses fall and
    equal the autodiff trajectory at rtol 1e-6."""
    jm = jax_model("hand")
    u, y = data()
    start = cbfssm_params_from_numpy(params_numpy(jm.init(jax.random.PRNGKey(0))),
                                     device="cpu")
    losses = {}
    for mode in ("hand", "autodiff"):
        pm = port_model(jm, mode)
        leaves = [t.clone().requires_grad_(True) for t in start.tensors()]
        opt = torch.optim.Adam(leaves, lr=0.05)
        losses[mode] = []
        for i in range(4):
            opt.zero_grad()
            loss, _ = pm.loss(start.with_tensors(leaves), u, y,
                              torch.Generator().manual_seed(3 + i), True)
            loss.backward()
            opt.step()
            losses[mode].append(float(loss.detach()))
    assert losses["hand"][-1] < losses["hand"][0]
    np.testing.assert_allclose(losses["hand"], losses["autodiff"], rtol=1e-6)


# --- Voliro, adjoint='parallel' ----------------------------------------------


@pytest.fixture(scope="module")
def voliro_case():
    """The JAX parallel loss and gradients (params, u, y), jitted once."""
    cfg = dict(voliro_config(), adjoint="parallel")
    jm = JaxVoliro(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    u, y = voliro_batch(np.random.default_rng(2), t=9)
    key = jax.random.PRNGKey(1)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, uu, yy: jm.loss(p, uu, yy, key, True)[0],
                                             argnums=(0, 1, 2)))(
        params, jnp.asarray(u), jnp.asarray(y))
    return cfg, params, u, y, key, float(loss), grads


def test_voliro_parallel_matches_autodiff_and_jax(voliro_case, backward_calls):
    cfg, params, u, y, key, want_loss, (g_p, g_u, g_y) = voliro_case
    tparams = convert.voliro_params_from_numpy(voliro_params_numpy(params), device="cpu")
    noise = voliro_noise(key, u.shape[0], u.shape[1], cfg["samples"])
    out = {}
    for mode in ("parallel", "autodiff"):
        pm = Voliro(dict(cfg, adjoint=mode), device="cpu")
        leaves = [t.clone().requires_grad_(True) for t in tparams.tensors()]
        uu, yy = torch.tensor(u, requires_grad=True), torch.tensor(y, requires_grad=True)
        loss, _ = pm.loss(tparams.with_tensors(leaves), uu, yy, noise=noise)
        grads = torch.autograd.grad(loss, leaves + [uu, yy])
        out[mode] = (float(loss), convert.voliro_params_to_numpy(
            tparams.with_tensors(grads[:-2])), grads[-2].numpy(), grads[-1].numpy())
    assert backward_calls["scan_outputs"] == 2  # the recognition and the physics rollout
    assert out["parallel"][0] == out["autodiff"][0]
    np.testing.assert_allclose(out["parallel"][0], want_loss, rtol=RTOL)
    assert_tree_close(out["parallel"][1], voliro_params_numpy(g_p), RTOL, 1e-11)
    np.testing.assert_allclose(out["parallel"][2], np.asarray(g_u), rtol=RTOL, atol=1e-11)
    np.testing.assert_allclose(out["parallel"][3], np.asarray(g_y), rtol=RTOL, atol=1e-11)


# --- the rules -----------------------------------------------------------------


@pytest.mark.parametrize("make, match", [
    (lambda: CBFSSMHALF(dict(half_config("rnn"), adjoint="hand"), device="cpu"),
     "does not implement"),
    (lambda: PRSSM(dict(prssm_config(), adjoint="parallel"), device="cpu"),
     "does not implement"),
    (lambda: Voliro(dict(voliro_config(), adjoint="hand"), device="cpu"), "does not implement"),
    (lambda: CBFSSM(dict(smoke_config(), adjoint="parallel"), device="cpu"),
     "does not implement"),
    (lambda: CBFSSM(dict(smoke_config(), adjoint="hand", gp_impl="pallas"), device="cpu"),
     "requires gp_impl='solve_free'"),
    (lambda: Voliro(dict(voliro_config(), adjoint="parallel", gp_impl="pallas"),
                    device="cpu"), "requires gp_impl='solve_free'"),
])
def test_unsupported_adjoints_are_refused(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_auto_resolves_to_autodiff():
    flags = {mode: CBFSSM(dict(smoke_config(), adjoint=mode), device="cpu")
             for mode in ("auto", "autodiff", "hand")}
    assert [m._hand_adjoint for m in flags.values()] == [False, False, True]
    assert not any(m._parallel_adjoint for m in flags.values())
    assert Voliro(dict(voliro_config(), adjoint="parallel"), device="cpu")._parallel_adjoint


# --- model_meta.json ----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_meta_with_hand_adjoint_rebuilds_trains_and_evaluates(tmp_path, writer,
                                                              backward_calls):
    """A directory whose model_meta.json says ``"adjoint": "hand"``,
    written by either package, rebuilds a hand model that trains,
    restores and evaluates."""
    cfg = dict(smoke_config(), adjoint="hand")
    path = str(tmp_path / "m")
    if writer == "jax":
        from cbfssm_tpu.models import CBFSSM as JaxCBFSSM

        os.makedirs(path)
        jax_store.save_model_meta(path, JaxCBFSSM(cfg), seed=0)
    else:
        Trainer(CBFSSM(cfg, device="cpu"), path)
    model = model_store.build_model(model_store.load_model_meta(path), device="cpu")
    assert model.config.adjoint == "hand" and model._hand_adjoint
    ds = SmokeDS()
    trainer = Trainer(model, path)
    trainer.train(ds, epochs=2)
    assert backward_calls["forward_scan"] > 0 and np.isfinite(trainer.train_all).all()
    loaded, params = model_store.load_trained_model(path, device="cpu")
    assert loaded._hand_adjoint
    loss, _ = loaded.loss(params, ds.test_in_batch[:2], ds.test_out_batch[:2],
                          torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))


def test_meta_with_parallel_adjoint_rebuilds_voliro(tmp_path):
    cfg = dict(voliro_config(), adjoint="parallel")
    path = str(tmp_path / "v")
    os.makedirs(path)
    jax_store.save_model_meta(path, JaxVoliro(cfg), seed=0)
    model = model_store.build_model(model_store.load_model_meta(path), device="cpu")
    assert isinstance(model, Voliro) and model._parallel_adjoint
