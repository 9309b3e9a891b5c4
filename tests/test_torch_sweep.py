"""The port's SweepTrainer on the CPU (float64): the cases of
tests/test_sweep.py, and the Voliro sweep's vmapped loss against JAX's
``SweptModel`` under ``jax.vmap`` with the same noise (rtol 1e-7).

Contract: a constant grid reproduces MultiSeedTrainer (the sweep adds
nothing numerically); swept values are pinned bitwise through training;
grid points differ; learning_rate sweeps through the optimizer;
structural fields, unread fields, scalar or empty sweeps, mismatched
lengths and a changed grid on retrain are rejected.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from cbfssm_tpu.models import Voliro as JaxVoliro
from cbfssm_tpu.training.sweep import SweptModel as JaxSweptModel
from cbfssm_tpu_torch import convert
from cbfssm_tpu_torch.models import CBFSSM, Voliro
from cbfssm_tpu_torch.outputs import Outputs
from cbfssm_tpu_torch.training import MultiSeedTrainer, SweepTrainer, SweptModel, checkpoint
from cbfssm_tpu_torch.training.multiseed import noise_like, stack_noise
from tests.test_torch_lanes import one_thread  # noqa: F401 (autouse)
from tests.test_torch_voliro import jax_noise as voliro_noise
from tests.test_torch_voliro import params_numpy as voliro_params_numpy
from tests.test_trainer import SmokeDS, smoke_config


@pytest.fixture(scope="module")
def ds():
    return SmokeDS()


def sweep_trainer(sweep, path, **kwargs):
    return SweepTrainer(CBFSSM, smoke_config(), sweep, str(path), device="cpu", **kwargs)


def test_constant_grid_matches_multiseed(ds, tmp_path):
    """Grid = the base config repeated, each point its own init: the
    losses of a plain MultiSeedTrainer (same seed)."""
    cfg = smoke_config()
    n = 2
    ms = MultiSeedTrainer(CBFSSM(cfg, device="cpu"), str(tmp_path / "ms"), n_seeds=n)
    ms.train(ds, epochs=2)
    sw = sweep_trainer({"k_factor": np.full(n, cfg["k_factor"]),
                        "loss_factors": np.tile(np.asarray(cfg["loss_factors"]), (n, 1))},
                       tmp_path / "sw", vary_init=True)
    sw.train(ds, epochs=2)
    np.testing.assert_allclose(np.stack(sw.train_all), np.stack(ms.train_all), rtol=1e-12)
    np.testing.assert_allclose(np.stack(sw.test_all), np.stack(ms.test_all), rtol=1e-12)


@pytest.fixture(scope="module")
def swept(ds, tmp_path_factory):
    out = tmp_path_factory.mktemp("grid")
    sweep = {"k_factor": np.asarray([1.0, 50.0, 200.0]),
             "loss_factors": np.asarray([[0.05, 0.0], [0.5, 0.0], [1.0, 0.1]])}
    trainer = sweep_trainer(sweep, out)
    trainer.train(ds, epochs=3)
    return trainer, sweep, str(out)


def test_grid_points_differ_and_train(swept):
    trainer = swept[0]
    losses = np.stack(trainer.train_all)
    assert np.isfinite(losses).all()
    assert len(np.unique(losses[-1])) == trainer.n_seeds


def test_hypers_pinned_bitwise(swept):
    """The swept leaves are not trained: their values never drift."""
    trainer, sweep, _ = swept
    hyper = trainer.params.hyper
    assert not any(v.requires_grad for v in hyper.values())
    np.testing.assert_array_equal(hyper["k_factor"].numpy(), sweep["k_factor"])
    np.testing.assert_array_equal(hyper["loss_factors"].numpy(), sweep["loss_factors"])
    assert len(trainer.opt.leaves) == len(trainer.params.model.tensors())


def test_shared_init_attributes_differences_to_grid(swept, tmp_path):
    """vary_init=False (default): every point starts from one init."""
    fresh = sweep_trainer({"k_factor": np.asarray([1.0, 50.0, 200.0])}, tmp_path)
    fresh.init_state()
    z = fresh.params.model.gp_f.z.detach()
    assert torch.equal(z[0], z[1]) and torch.equal(z[0], z[2])


def test_best_config_and_json(swept):
    trainer, sweep, out = swept
    best = trainer.best_config()
    i = trainer.best_seed()
    assert best["k_factor"] == pytest.approx(sweep["k_factor"][i])
    assert np.asarray(best["loss_factors"]) == pytest.approx(sweep["loss_factors"][i])
    with open(os.path.join(out, "sweep_best.json")) as f:
        assert json.load(f) == best


def test_seed_view_and_var_dump(swept, ds):
    trainer = swept[0]
    view = trainer.seed_view(1)
    pred = trainer.model.predict(view.params, ds.test_in_batch[:4], ds.test_out_batch[:4],
                                 torch.Generator().manual_seed(0))
    assert np.isfinite(pred.pred_mean.detach().numpy()).all()
    vd = trainer.model.var_dict(view.params)
    assert float(vd["sweep k_factor"]) == pytest.approx(50.0)


def test_learning_rate_sweep(ds, tmp_path):
    """A 0-lr lane does not move; a positive-lr lane does."""
    trainer = sweep_trainer({"learning_rate": np.asarray([0.0, 0.05])}, tmp_path / "lr")
    trainer.init_state()
    z0 = trainer.params.model.gp_f.z.detach().clone()
    trainer.train(ds, epochs=2)
    z1 = trainer.params.model.gp_f.z.detach()
    assert torch.equal(z1[0], z0[0])
    assert (z1[1] - z0[1]).abs().max() > 0
    assert trainer.best_config()["learning_rate"] in (0.0, 0.05)


def test_voliro_loss_time_fields_sweep_matches_jax():
    """The Voliro hypers (loglik_factor, the Beta priors) as lane
    tensors: one vmapped loss over a 2-point grid equals the JAX
    SweptModel's under jax.vmap, with the same per-lane noise."""

    class _DS:
        dim_u = 13
        dim_y = 22

    cfg = {
        "ds": _DS, "batch_size": 2, "ind_pnt_num": 4, "samples": 2, "learning_rate": 0.01,
        "loglik_factor": np.asarray([20.0, 0.0, 200.0]), "n_beta": [10.0, 2.0, 10.0],
        "l_beta": [1.0, 10.0, 10.0], "zeta_pos": 2.0, "zeta_mean": 0.0025, "zeta_var": 0.0001,
        "gp_var": 0.25, "gp_len": 5.0, "var_x": np.asarray([0.02] * 7 + [0.2] * 6) ** 2,
        "var_y": np.asarray([0.02] * 7 + [0.2] * 6) ** 2, "var_z": np.asarray([0.02] * 6),
        "dtype": "float64",
    }
    fields = ("loglik_factor", "n_beta")
    hyper = {"loglik_factor": np.asarray([[20.0, 0.0, 200.0], [5.0, 0.0, 50.0]]),
             "n_beta": np.asarray([[10.0, 2.0, 10.0], [5.0, 1.0, 5.0]])}
    jm = JaxSweptModel(JaxVoliro, cfg, fields)
    params = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(0), 2))
    params["hyper"] = {k: jnp.asarray(v) for k, v in hyper.items()}
    rng = np.random.default_rng(0)
    pwm = rng.uniform(0.3, 0.9, size=(2, 8, 6))
    tilt = rng.uniform(-0.5, 0.5, size=(2, 8, 6))
    ts = np.broadcast_to(np.arange(8.0)[None, :, None] * 0.02, (2, 8, 1))
    u = np.concatenate((pwm, tilt, ts), axis=-1)
    y = rng.normal(size=(2, 8, 22)) * 0.1
    q = rng.normal(size=(2, 8, 4))
    y[..., 12:16] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    want, _ = jax.jit(jax.vmap(lambda p, k: jm.loss(p, u, y, k, True)))(params, keys)

    pm = SweptModel(Voliro, cfg, fields, device="cpu")
    inner = convert.voliro_params_from_numpy(voliro_params_numpy(params["model"]), device="cpu")
    tparams = pm.init(torch.Generator().manual_seed(0))
    tparams = tparams.with_tensors([*inner.tensors(),
                                    *(torch.tensor(hyper[k]) for k in fields)])
    noises = [voliro_noise(keys[lane], 2, 8, 2) for lane in range(2)]
    got, _ = vmap(lambda lv, nts: pm.loss(tparams.with_tensors(lv), u, y,
                                          noise=noise_like(noises[0], nts)))(
        tparams.tensors(), stack_noise(noises))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    assert np.isfinite(got.numpy()).all() and got[0] != got[1]


def test_constant_grid_lanes_identical(ds, tmp_path):
    """Default (vary_init=False): one init, one shuffle, one noise
    stream, so a constant grid gives identical lanes."""
    trainer = sweep_trainer({"k_factor": np.full(3, smoke_config()["k_factor"])},
                            tmp_path / "const")
    trainer.train(ds, epochs=2)
    for losses in trainer.train_all:
        assert len(np.unique(losses)) == 1, losses


def test_best_ckpt_single_model_consumable(swept, ds):
    """best.ckpt holds the winning point's model tree alone, in
    Trainer's format."""
    from cbfssm_tpu_torch.training import Trainer

    trainer, _, out = swept
    model = CBFSSM(smoke_config(), device="cpu")
    restored = Trainer(model, out).restore(checkpoint.BEST)
    want = trainer.params_for(trainer.best_seed()).model
    for a, b in zip(restored.tensors(), want.tensors()):
        assert torch.equal(a.detach(), b)
    loss, _ = model.loss(restored, ds.test_in_batch[:4], ds.test_out_batch[:4],
                         torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss.detach()))


def test_evaluate_rmse_matches_outputs(swept, ds, tmp_path):
    """The lane-batched evaluation gives each point the RMSE that
    Outputs writes for it."""
    trainer = swept[0]
    rmse = trainer.evaluate_rmse(ds)
    assert rmse.shape == (trainer.n_seeds,)
    i = 1
    o = Outputs(str(tmp_path / "pt"))
    o.set_ds(ds)
    o.set_model(trainer.model, trainer.model_dir)
    o.set_trainer(trainer.seed_view(i))
    o.create_all()
    np.testing.assert_allclose(rmse[i], o.get_last_rmse(), rtol=1e-6)


@pytest.mark.parametrize("sweep,match", [
    ({"recog_len": np.asarray([4, 8])}, "not sweepable"),
    ({"loglik_factor": np.asarray([[20.0, 0.0, 200.0]] * 2)}, "not sweepable for CBFSSM"),
    ({"k_factor": 5.0}, "length-n array"),
    ({}, "at least one field"),
    ({"k_factor": np.asarray([1.0]), "learning_rate": np.asarray([0.1, 0.2])}, "share length"),
])
def test_bad_sweeps_rejected(sweep, match, tmp_path):
    """Structural fields, fields the model does not read, scalar and
    empty sweeps, and mismatched lengths fail before anything trains."""
    with pytest.raises(ValueError, match=match):
        sweep_trainer(sweep, tmp_path / "x")
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("field,first,changed", [
    ("k_factor", [1.0, 50.0], [5.0, 500.0]),
    ("learning_rate", [0.01, 0.05], [0.02, 0.05]),
    ("learning_rate", [0.01, 0.02], [0.01, 0.02, 0.03]),
])
def test_retrain_with_changed_grid_fails_fast(ds, tmp_path, field, first, changed):
    """A changed grid (values or length) on retrain would train the
    checkpoint's old values while best_config() reports the new ones:
    it raises; the original grid resumes."""
    out = tmp_path / "regrid"
    sweep_trainer({field: np.asarray(first)}, out).train(ds, epochs=1)
    t2 = sweep_trainer({field: np.asarray(changed)}, out)
    match = (f"retrain grid mismatch for '{field}'" if len(changed) == len(first)
             else "3 lanes")
    with pytest.raises(ValueError, match=match):
        t2.init_state(retrain=True)
    t3 = sweep_trainer({field: np.asarray(first)}, out)
    t3.train(ds, epochs=1, retrain=True)
    assert np.isfinite(np.stack(t3.train_all)).all()


def test_product_grid_seed_replication(ds, tmp_path):
    """Points x seeds in one program: replicates of one point share the
    value and differ in init and stream (vary_init=True); grouped()
    folds the lanes back per point."""
    sweep = SweepTrainer.product_grid({"k_factor": np.asarray([10.0, 200.0])},
                                      seeds_per_point=2)
    np.testing.assert_array_equal(sweep["k_factor"], [10.0, 10.0, 200.0, 200.0])
    trainer = sweep_trainer(sweep, tmp_path / "pg", vary_init=True)
    trainer.train(ds, epochs=2)
    losses = SweepTrainer.grouped(np.stack(trainer.train_all)[-1], 2)
    assert losses.shape == (2, 2) and losses[0, 0] != losses[0, 1]
    rmse = SweepTrainer.grouped(trainer.evaluate_rmse(ds), 2)
    assert rmse.shape == (2, 2) and np.isfinite(rmse).all()
