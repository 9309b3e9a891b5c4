"""The port's CBFSSMHALF and PRSSM against ``cbfssm_tpu.models`` (CPU,
float64, the sizes of tests/test_other_models.py: B 2, T 8, M 5, S 3).

Both packages get the same parameters (the JAX pytree, flax recognition
tree included, through ``cbfssm_tpu_torch.convert``) and the same random
numbers: the JAX models draw the rollout noise straight from the loss
key, ``normal(key, (T-1, B, S, 1))``, and the port takes that array as
``noise=``. Loss, every aux entry and predict agree at rtol 1e-7 (the
golden tolerance of tests/test_cbfssm_model.py), every gradient leaf at
rtol 1e-6, the recognition nets alone at rtol 1e-12.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbfssm_tpu.models import CBFSSMHALF as JaxCBFSSMHALF
from cbfssm_tpu.models import PRSSM as JaxPRSSM
from cbfssm_tpu.models import recognition as jax_recognition
from cbfssm_tpu_torch import convert
from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF, PRSSM, recognition
from cbfssm_tpu_torch.outputs import Outputs
from cbfssm_tpu_torch.training import Trainer, checkpoint
from tests.test_other_models import half_config, prssm_config
from tests.test_trainer import SmokeDS

RTOL = 1e-7
GRAD_RTOL = 1e-6
MODELS = {"half": (JaxCBFSSMHALF, CBFSSMHALF, convert.cbfssmhalf_params_from_numpy),
          "prssm": (JaxPRSSM, PRSSM, convert.prssm_params_from_numpy)}


def config(name, recog):
    return prssm_config(recog, 16) if recog == "conv" else half_config(recog)


def params_numpy(params):
    """A JAX CBFSSMHALFParams / PRSSMParams as the nested numpy dict
    that convert takes."""
    return {"gp_f": {k: np.asarray(getattr(params.gp_f, k)) for k in convert.GP_LEAVES},
            "var_x_unc": np.asarray(params.var_x_unc), "var_y_unc": np.asarray(params.var_y_unc),
            "recog": jax.tree_util.tree_map(np.asarray, params.recog)}


@pytest.fixture(scope="module")
def setups():
    """(jax model, jax params, port model, port params) per (model,
    recognition), built once for the module."""
    cache = {}

    def get(name, recog, **overrides):
        key = (name, recog, tuple(sorted(overrides.items())))
        if key not in cache:
            jax_cls, port_cls, from_numpy = MODELS[name]
            cfg = dict(config(name, recog), **overrides)
            jm = jax_cls(cfg)
            params = jm.init(jax.random.PRNGKey(0))
            pm = port_cls(cfg, device="cpu")
            cache[key] = (jm, params, pm, from_numpy(params_numpy(params), device="cpu"))
        return cache[key]

    return get


def batch(t_len=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, t_len, 2)), rng.normal(size=(2, t_len, 1))


def jax_eps(key, t_len, b, s):
    """The JAX rollout's draws for ``key`` (cbfssmhalf.py:157, prssm.py:120)."""
    return torch.tensor(np.asarray(jax.random.normal(key, (t_len - 1, b, s, 1),
                                                     dtype=jnp.float64)))


CASES = [("half", "rnn", True), ("half", "rnn", False), ("half", "output", True),
         ("half", "output", False), ("prssm", "rnn", True), ("prssm", "output", True),
         ("prssm", "conv", True)]


@pytest.mark.parametrize("name,recog,condition", CASES)
def test_loss_aux_and_predict_match_jax(setups, name, recog, condition):
    jm, params, pm, tparams = setups(name, recog)
    u, y = batch(20 if recog == "conv" else 8)
    key = jax.random.PRNGKey(3)
    eps = jax_eps(key, u.shape[1], 2, pm.samples)
    (want, want_aux), want_p = jax.jit(lambda p: (
        jm.loss(p, u, y, key, condition=condition), jm.predict(p, u, y, key, condition=condition)
    ))(params)
    got, got_aux = pm.loss(tparams, u, y, condition=condition, noise=eps)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert set(got_aux) == set(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]), rtol=RTOL, atol=1e-12,
                                   err_msg=k)
    got_p = pm.predict(tparams, u, y, condition=condition, noise=eps)
    for f in dataclasses.fields(got_p):
        np.testing.assert_allclose(getattr(got_p, f.name).numpy(),
                                   np.asarray(getattr(want_p, f.name)), rtol=RTOL, atol=1e-12,
                                   err_msg=f.name)


@pytest.mark.parametrize("name", ["half", "prssm"])
def test_grads_match_jax(setups, name):
    """Every leaf, the recognition net's included, against jax.grad."""
    jm, params, pm, tparams = setups(name, "rnn")
    u, y = batch(seed=1)
    key = jax.random.PRNGKey(4)
    want = params_numpy(jax.jit(jax.grad(lambda p: jm.loss(p, u, y, key, True)[0]))(params))
    leaves = [t.clone().requires_grad_(True) for t in tparams.tensors()]
    loss, _ = pm.loss(tparams.with_tensors(leaves), u, y, noise=jax_eps(key, 8, 2, pm.samples))
    got = convert.cbfssmhalf_params_to_numpy(
        tparams.with_tensors(torch.autograd.grad(loss, leaves)))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want) == 5 + 2 + 12  # flax: 10 GRU leaves, 2 Dense
    for path, g in flat_got:
        w = flat_want[path]
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=1e-10 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    assert np.abs(got["recog"]["params"]["GRUCell_0"]["ir"]["kernel"]).max() > 0


@pytest.mark.parametrize("recog,t_len", [("rnn", 4), ("conv", 16)])
def test_recognition_nets_match_flax(recog, t_len):
    flax_net = jax_recognition.make_recognition(recog, 3, jnp.float64)
    rng = np.random.default_rng(5)
    uy = rng.normal(size=(4, t_len, 3))
    tree = jax.tree_util.tree_map(np.asarray, flax_net.init(jax.random.PRNGKey(1), uy))
    want = np.asarray(flax_net.apply(tree, uy))
    net = recognition.make_recognition(recog, 3, 3, t_len, torch.float64)
    leaves = convert._recognition_from_flax(tree, lambda a: torch.tensor(a))
    assert tuple(leaves) == net.LEAVES
    got = recognition.apply(net, leaves, torch.tensor(uy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name,recog", [("half", "rnn"), ("prssm", "rnn")])
def test_gp_impl_pallas_on_cpu_equals_solve_free(setups, name, recog):
    _, _, plain, tparams = setups(name, recog)
    _, _, fused, _ = setups(name, recog, gp_impl="pallas")
    u, y = batch(seed=2)
    eps = jax_eps(jax.random.PRNGKey(6), 8, 2, plain.samples)
    np.testing.assert_allclose(float(fused.loss(tparams, u, y, noise=eps)[0]),
                               float(plain.loss(tparams, u, y, noise=eps)[0]), rtol=1e-10)


@pytest.mark.parametrize("cls,override,match", [
    (CBFSSMHALF, {"dim_x": 0, "var_x": np.zeros(0)}, "dim_x >= dim_y"),
    (PRSSM, {"dim_x": 0, "var_x": np.zeros(0)}, "dim_x >= dim_y"),
    (CBFSSMHALF, {"recog_model": "conv"}, "'output' and 'rnn'"),
    (PRSSM, {"recog_model": "conv", "recog_len": 8}, "recog_len == 16"),
    (PRSSM, {"recog_model": "gru"}, "invalid recognition model"),
    (CBFSSMHALF, {"var_y": np.asarray([0.5, 0.5])}, "var_y"),
    (PRSSM, {"var_x": np.asarray([0.1])}, "var_x"),
])
def test_config_errors(cls, override, match):
    with pytest.raises(ValueError, match=match):
        cls(dict(half_config("rnn"), **override), device="cpu")


def test_init_draws_and_empty_recognition_kind():
    pm = CBFSSMHALF(dict(half_config("rnn"), recog_model=""), device="cpu")
    assert pm.recog_kind == "rnn"
    p = pm.init(torch.Generator().manual_seed(0))
    assert tuple(p.recog) == recognition.GRURecognition.LEAVES
    assert tuple(p.recog["cell.weight_hh"].shape) == (48, 16)
    block = p.recog["cell.weight_hh"][:16]
    torch.testing.assert_close(block @ block.T, torch.eye(16, dtype=torch.float64))
    assert p.recog["readout.weight"].abs().max() <= 2 * (1 / 16) ** 0.5 / 0.87962566103423978
    assert len(pm.var_dict(p)) == 7 and len(p.tensors()) == 5 + 2 + 6
    assert p.to(torch.float32).recog["cell.bias_hn"].dtype == torch.float32
    conv = PRSSM(prssm_config("conv", 16), device="cpu").init(torch.Generator().manual_seed(0))
    assert tuple(conv.recog["conv.weight"].shape) == (5, 3, 3) and len(conv.tensors()) == 11
    assert PRSSM(prssm_config("output"), device="cpu").init(torch.Generator()).recog == {}


@pytest.mark.parametrize("name,recog", [("half", "rnn"), ("prssm", "conv"), ("prssm", "output")])
def test_convert_round_trip_and_missing_leaf(setups, name, recog):
    _, params, _, tparams = setups(name, recog)
    tree = params_numpy(params)
    back = convert.cbfssmhalf_params_to_numpy(tparams)
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(jax.tree_util.tree_leaves(back)) == len(flat)
    for path, a in jax.tree_util.tree_leaves_with_path(back):
        np.testing.assert_array_equal(a, flat[path], err_msg=jax.tree_util.keystr(path))
    p32 = MODELS[name][2](tree, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in p32.tensors())
    if recog != "output":
        leaf = "hz" if recog == "rnn" else "Conv_0"
        layer = tree["recog"]["params"]["GRUCell_0"] if recog == "rnn" else tree["recog"]["params"]
        del layer[leaf]
        with pytest.raises(KeyError, match=leaf):
            MODELS[name][2](tree, device="cpu")


@pytest.mark.parametrize("cls", [CBFSSMHALF, PRSSM])
def test_trainer_two_epochs_and_checkpoints(tmp_path, cls):
    ds = SmokeDS()
    cfg = dict(half_config("rnn"), ds=SmokeDS, batch_size=8, var_y=np.asarray([1.0]),
               dim_x=2, var_x=np.asarray([0.002**2] * 2), learning_rate=0.05)
    model = cls(cfg, device="cpu")
    tr = Trainer(model, str(tmp_path / "m"), seed=1)
    tr.train(ds, epochs=2)
    assert np.isfinite(tr.train_all).all() and np.isfinite(tr.test_all).all()
    assert len(tr.params.tensors()) == 13
    for name in (checkpoint.BEST, checkpoint.LAST):
        assert checkpoint.exists(os.path.join(str(tmp_path / "m"), name))
    restored = Trainer(model, str(tmp_path / "m")).restore(checkpoint.LAST)
    for a, b in zip(restored.tensors(), tr.params.tensors(), strict=True):
        assert torch.equal(a.detach(), b.detach())
    out = Outputs(str(tmp_path / "out"))
    out.set_model(model, str(tmp_path / "m"))
    best = checkpoint.restore(os.path.join(str(tmp_path / "m"), checkpoint.BEST))["params"]
    for a, b in zip(out._restore_params().tensors(), best, strict=True):
        assert torch.equal(a, b)


def test_tf32_is_refused_on_the_card():
    """A float32 model on a CUDA device raises while cuBLAS may use TF32,
    at construction and at the entry points. Building a model allocates
    nothing, so this runs without a card."""
    matmul = torch.backends.cuda.matmul
    before = torch.get_float32_matmul_precision()
    cfg32 = dict(half_config("rnn"), dtype="float32")
    try:
        matmul.allow_tf32 = True
        for cls, cfg in ((CBFSSM, dict(cfg32, var_y=np.asarray([0.5] * 3))),
                         (CBFSSMHALF, cfg32), (PRSSM, cfg32)):
            with pytest.raises(ValueError, match="allow_tf32"):
                cls(cfg, device="cuda")
        matmul.allow_tf32 = False
        CBFSSMHALF(dict(cfg32, dtype="float64"), device="cuda")  # float64: no check
        models = [CBFSSM(dict(cfg32, var_y=np.asarray([0.5] * 3)), device="cuda"),
                  CBFSSMHALF(cfg32, device="cuda"), PRSSM(cfg32, device="cuda")]
        torch.set_float32_matmul_precision("high")  # sets the same flag
        u, y = batch()
        for model in models:
            with pytest.raises(ValueError, match="allow_tf32"):
                model.loss(None, u, y, torch.Generator())
            with pytest.raises(ValueError, match="allow_tf32"):
                model.predict(None, u, y, torch.Generator())
        with pytest.raises(ValueError, match="allow_tf32"):
            models[1].filter_ops(None)
    finally:
        matmul.allow_tf32 = False
        torch.set_float32_matmul_precision(before)
