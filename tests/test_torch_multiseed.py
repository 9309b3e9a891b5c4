"""The port's MultiSeedTrainer on the CPU (float64), with the cases of
tests/test_multiseed.py that need no mesh, and against the JAX package's
MultiSeedTrainer fed the same init and noise (losses rtol 1e-6).

Also: one lane of the per-lane Adam equals ``torch.optim.Adam`` on the
single model over 3 steps (rtol 1e-12), and the per-lane non-finite
guard leaves the healthy lanes exactly as an unpoisoned run leaves them.
"""

import os

import jax
import numpy as np
import pytest
import torch

from cbfssm_tpu.models import CBFSSM as JaxCBFSSM
from cbfssm_tpu.training import MultiSeedTrainer as JaxMultiSeedTrainer
from cbfssm_tpu_torch.convert import cbfssm_params_from_numpy
from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF
from cbfssm_tpu_torch.outputs import Outputs
from cbfssm_tpu_torch.training import MultiSeedTrainer, Trainer, checkpoint
from cbfssm_tpu_torch.training.multiseed import BEST_SEEDS, LAST_SEEDS, LaneAdam
from tests.test_torch_cbfssm import jax_noise, params_numpy
from tests.test_torch_lanes import one_thread  # noqa: F401 (autouse)
from tests.test_trainer import SmokeDS, smoke_config


def port_model(**overrides):
    return CBFSSM(dict(smoke_config(), **overrides), device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ds = SmokeDS()
    model = port_model()
    out = str(tmp_path_factory.mktemp("ms"))
    trainer = MultiSeedTrainer(model, out, n_seeds=3)
    trainer.train(ds, epochs=3)
    return trainer, model, ds, out


def test_all_seeds_train(trained):
    trainer = trained[0]
    losses = np.stack(trainer.train_all)  # [epochs, n_seeds]
    assert losses.shape == (3, 3)
    assert np.isfinite(losses).all() and np.isfinite(np.stack(trainer.test_all)).all()
    assert (losses[-1] < losses[0]).all()


def test_seeds_are_independent(trained):
    trainer = trained[0]
    assert len(np.unique(np.stack(trainer.train_all)[-1])) == trainer.n_seeds
    z = trainer.params.gp_f.z.detach()
    assert not torch.equal(z[0], z[1]) and not torch.equal(z[1], z[2])


def test_best_tracking_matches_replay(trained):
    trainer = trained[0]
    losses = np.stack(trainer.train_all)
    np.testing.assert_allclose(trainer.best_loss, losses.min(axis=0), rtol=1e-12)
    assert trainer.best_seed() == int(np.argmin(losses.min(axis=0)))


def test_params_for_slices_and_evaluates(trained):
    trainer, model, ds, _ = trained
    p0, p1 = trainer.params_for(0), trainer.params_for(1)
    loss, _ = model.loss(p0, ds.test_in_batch[:4], ds.test_out_batch[:4],
                         torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))
    assert (p0.gp_f.z - p1.gp_f.z).abs().max() > 0
    assert torch.equal(p0.gp_f.z, trainer.best_params[0][0])


def test_checkpoint_roundtrip(trained):
    trainer, _, _, out = trained
    tree = checkpoint.restore(os.path.join(out, BEST_SEEDS))
    assert len(tree["params"]) == len(trainer.best_params)
    for a, b in zip(tree["params"], trainer.best_params):
        assert torch.equal(a, b)
    last = checkpoint.restore(os.path.join(out, LAST_SEEDS))
    for a, b in zip(last["params"], trainer.params.tensors()):
        assert torch.equal(a, b.detach())
    assert torch.equal(last["opt_state"]["step"], torch.full((3,), 12.0, dtype=torch.float64))


def test_single_model_best_ckpt_is_best_seed(trained):
    """best.ckpt holds the best lane's unstacked tree in Trainer's
    format: Trainer.restore loads it, params and Adam state."""
    trainer, model, ds, out = trained
    restored = Trainer(model, out).restore(checkpoint.BEST)
    want = trainer.params_for(trainer.best_seed())
    for a, b in zip(restored.tensors(), want.tensors()):
        assert torch.equal(a.detach(), b)
    loss, _ = model.loss(restored, ds.test_in_batch[:4], ds.test_out_batch[:4],
                         torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss.detach()))
    tr = Trainer(model, out)
    tr.restore(checkpoint.LAST)
    state = tr.optimizer.state_dict()["state"]
    assert float(state[0]["step"]) == 12.0
    i = trainer.best_seed()
    assert torch.equal(state[0]["exp_avg"], trainer.opt.exp_avg[0][i])
    for a, b in zip(tr.params.tensors(), trainer.params_for(i, best=False).tensors()):
        assert torch.equal(a.detach(), b)


def test_trainerless_outputs_after_vmapped_run(trained, tmp_path):
    """Outputs restores best.ckpt with no trainer (the reference's
    re-evaluation path) and gives the best lane's RMSE."""
    trainer, model, ds, out = trained
    o = Outputs(str(tmp_path / "reeval"))
    o.set_ds(ds)
    o.set_model(model, out)
    o.create_all()
    assert np.isfinite(o.get_last_rmse())
    np.testing.assert_allclose(o.get_last_rmse(), trainer.evaluate_rmse(ds)[trainer.best_seed()],
                               rtol=1e-9)


def test_seed_view_and_calibration(trained):
    trainer, _, ds, _ = trained
    view = trainer.seed_view(2)
    assert view.train_all == [float(a[2]) for a in trainer.train_all]
    assert torch.equal(view.restore(checkpoint.BEST).gp_f.z, trainer.params_for(2).gp_f.z)
    assert torch.equal(view.params.gp_f.z, trainer.params.gp_f.z[2].detach())
    with pytest.raises(IndexError):
        trainer.seed_view(3)
    stats = trainer.evaluate_calibration(ds)
    assert len(stats) == 3 and all(np.isfinite(s["nll"]) for s in stats)


def test_multiseed_with_gru_recognition(tmp_path):
    cfg = dict(smoke_config(), recog_model="rnn", recog_len=4, var_y=np.asarray([1.0]))
    model = CBFSSMHALF(cfg, device="cpu")
    trainer = MultiSeedTrainer(model, str(tmp_path / "half"), n_seeds=2)
    ds = SmokeDS()
    trainer.train(ds, epochs=2)
    assert np.isfinite(np.stack(trainer.train_all)).all()
    loss, _ = model.loss(trainer.params_for(0), ds.test_in_batch[:4], ds.test_out_batch[:4],
                         torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))


def test_multiseed_retrain_resumes(tmp_path):
    ds = SmokeDS()
    model = port_model()
    out = str(tmp_path / "msr")
    t1 = MultiSeedTrainer(model, out, n_seeds=2)
    t1.train(ds, epochs=2)
    final = t1.params.gp_f.z.detach().clone()
    t2 = MultiSeedTrainer(model, out, n_seeds=2)
    t2.init_state(retrain=True)
    assert torch.equal(t2.params.gp_f.z.detach(), final)
    t2.train(ds, epochs=1, retrain=True)
    assert np.isfinite(np.stack(t2.train_all)).all()
    assert torch.equal(t2.opt.step_count, torch.full((2,), 12.0, dtype=torch.float64))
    with pytest.raises(ValueError, match="3 lanes"):
        MultiSeedTrainer(model, out, n_seeds=3).init_state(retrain=True)


@pytest.mark.parametrize("kwargs,match", [({"mesh": object()}, "A6.1"),
                                          ({"epochs_per_dispatch": "fast"}, "A4.1")])
def test_rejects_what_is_not_ported(tmp_path, kwargs, match):
    """A mesh that is not a DeviceMesh, and an epochs_per_dispatch that
    is neither 'auto' nor an integer (fused dispatch itself is ported:
    tests/test_torch_blocked_epochs.py)."""
    with pytest.raises(ValueError, match=match):
        MultiSeedTrainer(port_model(), str(tmp_path), n_seeds=2, **kwargs)


def test_lane_adam_equals_torch_adam():
    """Lane 1 of a 3-lane LaneAdam (its own learning rate) against
    torch.optim.Adam on that lane's leaves alone, 3 steps."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(4, 3), (5,), ()]
    leaves = [torch.randn((3,) + s, generator=gen, dtype=torch.float64) for s in shapes]
    lrs = np.asarray([0.01, 0.05, 0.2])
    opt = LaneAdam([t.clone() for t in leaves], lrs)
    single = [t[1].clone().requires_grad_(True) for t in leaves]
    ref = torch.optim.Adam(single, lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        grads = [torch.randn(t.shape, generator=gen, dtype=torch.float64) for t in leaves]
        opt.step(grads)
        for p, g in zip(single, grads):
            p.grad = g[1].clone()
        ref.step()
    for got, want in zip(opt.leaves, single):
        torch.testing.assert_close(got[1], want.detach(), rtol=1e-12, atol=0)
    for got, state in zip(opt.exp_avg_sq, ref.state.values()):
        torch.testing.assert_close(got[1], state["exp_avg_sq"], rtol=1e-12, atol=0)
    assert torch.equal(opt.step_count, torch.full((3,), 3.0, dtype=torch.float64))


def test_nonfinite_guard_keeps_healthy_lanes(tmp_path):
    """A NaN in lane 1's data: lane 1 skips those steps (params, moments
    and count kept), lanes 0 and 2 train exactly as without it."""
    ds = SmokeDS()
    model = port_model(skip_nonfinite_updates=True)
    runs = {}
    for name in ("clean", "poisoned"):
        tr = MultiSeedTrainer(model, str(tmp_path / name), n_seeds=3)
        tr.init_state()
        data_u, data_y = (torch.as_tensor(a[:8]) for a in (ds.train_in_batch, ds.train_out_batch))
        u = data_u.expand(3, *data_u.shape).clone()
        y = data_y.expand(3, *data_y.shape).clone()
        if name == "poisoned":
            y[1, 0, 3, 0] = float("nan")
        w = torch.ones((3, 8), dtype=torch.float64)
        before = [t.detach().clone() for t in tr.params.tensors()]
        applied = []
        for i in range(2):
            _, ok = tr.train_step(u, y, w, tr._noises(0, 0, i, 8, 12))
            applied.append(ok.tolist())
        runs[name] = (tr, before, applied)
    clean, poisoned = runs["clean"][0], runs["poisoned"][0]
    assert runs["clean"][2] == [[True] * 3] * 2
    assert runs["poisoned"][2] == [[True, False, True]] * 2
    for a, b, b0 in zip(poisoned.params.tensors(), clean.params.tensors(), runs["poisoned"][1]):
        for lane in (0, 2):
            assert torch.equal(a[lane], b[lane])
        assert torch.equal(a[1].detach(), b0[1])
    assert poisoned.opt.step_count.tolist() == [2.0, 0.0, 2.0]
    assert all(float(m[1].abs().max()) == 0.0 for m in poisoned.opt.exp_avg)
    # in a training run the skips are counted per lane
    ds_bad = SmokeDS()
    ds_bad.train_out_batch = ds_bad.train_out_batch.copy()
    ds_bad.train_out_batch[5, 0, 0] = np.nan
    tr = MultiSeedTrainer(model, str(tmp_path / "run"), n_seeds=2)
    tr.train(ds_bad, epochs=1)
    assert tr.skipped_steps == 2  # one batch in each lane holds window 5


def test_matches_jax_multiseed_trainer(tmp_path):
    """The port, fed the JAX trainer's stacked init and its per-lane keys'
    noise, gives the JAX MultiSeedTrainer's losses and params."""
    ds = SmokeDS()
    seed, lanes = 2, 2
    jm = JaxCBFSSM(smoke_config())
    jt = JaxMultiSeedTrainer(jm, str(tmp_path / "jax"), n_seeds=lanes, seed=seed)
    jt.train(ds, epochs=2)

    pm = port_model()
    init = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(seed), lanes))
    base = jax.random.PRNGKey(seed + 1)

    def noise_fn(epoch, split, i, lane, b, t_len):
        ekey = jax.random.fold_in(jax.random.fold_in(base, epoch), split)
        key = jax.random.fold_in(jax.random.split(ekey, lanes)[lane], i)
        return jax_noise(pm, key, t_len, b)

    pt = MultiSeedTrainer(pm, str(tmp_path / "port"), n_seeds=lanes, seed=seed,
                          init_params=cbfssm_params_from_numpy(params_numpy(init), device="cpu"),
                          noise_fn=noise_fn)
    pt.train(ds, epochs=2)
    np.testing.assert_allclose(np.stack(pt.train_all), np.stack(jt.train_all), rtol=1e-6)
    np.testing.assert_allclose(np.stack(pt.test_all), np.stack(jt.test_all), rtol=1e-6)
    np.testing.assert_allclose(pt.params.gp_f.z.detach().numpy(), np.asarray(jt.params.gp_f.z),
                               rtol=1e-6, atol=1e-12)
    assert pt.best_seed() == jt.best_seed()
