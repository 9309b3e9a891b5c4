"""Training in the port against the JAX package (CPU, float64).

- The gradient of the port's ``CBFSSM.loss`` with respect to every
  parameter leaf equals ``jax.grad`` of the JAX loss at rtol 1e-7 (the
  tolerance of tests/test_adjoint.py), for both recognition schedules,
  both ``condition`` values, both ``gp_impl`` values and pad weights.
  Both packages get the same params (``convert``) and noise
  (``jax_noise``).
- The port's ``Trainer`` reproduces the JAX ``Trainer`` over 2 epochs of
  tests/test_trainer.py's SmokeDS from the same init params, shuffles
  and noise: per-epoch losses and final params at rtol 1e-6.
- Checkpoints, resume, the non-finite guard, metrics and determinism of
  the port's own trainer.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbfssm_tpu.models import CBFSSM as JaxCBFSSM
from cbfssm_tpu.training import Trainer as JaxTrainer
from cbfssm_tpu.training import trainer as jax_trainer
from cbfssm_tpu_torch.convert import cbfssm_params_from_numpy, cbfssm_params_to_numpy
from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.training import Trainer, checkpoint
from cbfssm_tpu_torch.training import trainer as port_trainer
from cbfssm_tpu_torch.utils.profiling import StepTimer
from tests.test_cbfssm_model import make_model
from tests.test_torch_cbfssm import batch, jax_noise, pair, params_numpy, port_config
from tests.test_trainer import SmokeDS, smoke_config

GRAD_RTOL = 1e-7


def assert_trees_close(got: dict, want: dict, rtol, atol=0.0):
    for top in ("gp_f", "gp_b"):
        for name in want[top]:
            np.testing.assert_allclose(got[top][name], np.asarray(want[top][name]), rtol=rtol,
                                       atol=atol, err_msg=f"{top}.{name}")
    for name in ("var_x_unc", "var_y_unc"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=rtol, atol=atol,
                                   err_msg=name)


def port_grads(pm, params, u, y, condition, weights, noise):
    leaves = [t.clone().requires_grad_(True) for t in params.tensors()]
    loss, _ = pm.loss(type(params).from_tensors(leaves), u, y, condition=condition,
                      weights=weights, noise=noise)
    grads = torch.autograd.grad(loss, leaves)
    return loss, cbfssm_params_to_numpy(type(params).from_tensors(grads))


@pytest.mark.parametrize("gp_impl", ["solve_free", "pallas"])
@pytest.mark.parametrize("condition", [True, False])
@pytest.mark.parametrize("mode", ["sequential", "blocked"])
def test_loss_grads_match_jax(mode, condition, gp_impl):
    jm, pm = pair(backward_mode=mode, gp_impl=gp_impl)
    jm.config.gp_impl = gp_impl
    u, y = batch(seed=1)
    key = jax.random.PRNGKey(3)
    params = jm.init(jax.random.PRNGKey(0))
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss(p, u, y, key, condition)[0])(params)
    loss, got = port_grads(pm, cbfssm_params_from_numpy(params_numpy(params), device="cpu"),
                           u, y, condition, None, jax_noise(pm, key, 8, 2))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=GRAD_RTOL)
    assert_trees_close(got, params_numpy(want), rtol=GRAD_RTOL, atol=1e-12)


@pytest.mark.parametrize("gp_impl", ["solve_free", "pallas"])
def test_padded_weight_grads_match_jax(gp_impl):
    """A zero-weight pad row contributes nothing: gradients equal JAX's
    weighted loss, and the pad row's content does not move them."""
    jm, pm = pair(backward_mode="blocked", gp_impl=gp_impl)
    jm.config.gp_impl = gp_impl
    u, y = batch(seed=2)
    w = np.asarray([1.0, 0.0])
    key = jax.random.PRNGKey(4)
    params = jm.init(jax.random.PRNGKey(1))
    want = jax.grad(lambda p: jm.loss(p, u, y, key, True, jnp.asarray(w))[0])(params)
    tparams = cbfssm_params_from_numpy(params_numpy(params), device="cpu")
    noise = jax_noise(pm, key, 8, 2)
    _, got = port_grads(pm, tparams, u, y, True, w, noise)
    assert_trees_close(got, params_numpy(want), rtol=GRAD_RTOL, atol=1e-12)
    u2, y2 = u.copy(), y.copy()
    u2[1] *= 30.0
    y2[1] -= 5.0
    _, got2 = port_grads(pm, tparams, u2, y2, True, w, noise)
    assert_trees_close(got2, got, rtol=1e-10)


@pytest.mark.parametrize("gp_impl", ["solve_free", "pallas"])
def test_dim_h_zero_loss_and_grads_match_jax(gp_impl):
    """dim_x = dim_y (TinyDS dim_y 1): the recognition GP has no output
    column, so its predicts have D = 0 (on the card the residual kernel
    then runs with no output column). The tests/test_serving.py:43 /
    tests/test_adjoint.py:73 pipeline for the port: loss and every
    gradient leaf against JAX."""
    jm = make_model(dim_x=1)
    jm.config.gp_impl = gp_impl
    pm = CBFSSM(port_config(jm, gp_impl=gp_impl), device="cpu")
    assert pm.dim_h == 0
    u, y = batch(seed=4)
    key = jax.random.PRNGKey(8)
    params = jm.init(jax.random.PRNGKey(2))
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, u, y, key, True)[0]))(
        params)
    loss, got = port_grads(pm, cbfssm_params_from_numpy(params_numpy(params), device="cpu"),
                           u, y, True, None, jax_noise(pm, key, 8, 2))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=GRAD_RTOL)
    assert got["gp_b"]["mean"].shape == (5, 0)
    assert_trees_close(got, params_numpy(want), rtol=GRAD_RTOL, atol=1e-12)


def jax_key_noise(pm, seed):
    """The JAX trainer's per-batch keys (trainer.py:401, 440-449,
    166, 194), drawn as the model draws them: the ``noise_fn`` seam."""
    base = jax.random.PRNGKey(seed + 1)

    def noise_fn(epoch, split, i, b, t_len):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(base, epoch), split), i)
        return jax_noise(pm, key, t_len, b)

    return noise_fn


def test_trainer_matches_jax_trainer(tmp_path, capsys):
    ds = SmokeDS()
    seed = 3
    jm = JaxCBFSSM(smoke_config())
    jt = JaxTrainer(jm, str(tmp_path / "jax"), seed=seed)
    jt.train(ds, epochs=2)

    pm = CBFSSM(smoke_config(), device="cpu")
    init = cbfssm_params_from_numpy(params_numpy(jm.init(jax.random.PRNGKey(seed))), device="cpu")
    pt = Trainer(pm, str(tmp_path / "port"), seed=seed, init_params=init,
                 noise_fn=jax_key_noise(pm, seed))
    pt.train(ds, epochs=2)
    np.testing.assert_allclose(pt.train_all, jt.train_all, rtol=1e-6)
    np.testing.assert_allclose(pt.test_all, jt.test_all, rtol=1e-6)
    assert_trees_close(cbfssm_params_to_numpy(pt.params), params_numpy(jt.params), rtol=1e-6,
                       atol=1e-12)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[000")]
    assert len(lines) == 4 and lines[2].startswith("[0000]: Train ")
    assert lines[2].split("  (")[0] == f"[0000]: Train {pt.train_all[0]}, Test {pt.test_all[0]}"


@pytest.mark.parametrize("n,batch_size,shuffle", [(28, 8, True), (8, 8, False), (5, 4, True)])
def test_epoch_indices_equal_jax(n, batch_size, shuffle):
    got = port_trainer.epoch_indices(np.random.default_rng(7), n, batch_size, shuffle, np.float64)
    want = jax_trainer.epoch_indices(np.random.default_rng(7), n, batch_size, shuffle, jnp.float64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.dtype == np.asarray(w).dtype


def small_trainer(path, seed=0, **config):
    return Trainer(CBFSSM(dict(smoke_config(), **config), device="cpu"), str(path), seed=seed)


def test_same_seed_same_losses_other_seed_differs(tmp_path):
    ds = SmokeDS()
    runs = [small_trainer(tmp_path / f"r{k}", seed=s) for k, s in enumerate((0, 0, 1))]
    for tr in runs:
        tr.train(ds, epochs=2)
    assert runs[0].train_all == runs[1].train_all and runs[0].test_all == runs[1].test_all
    assert runs[0].train_all != runs[2].train_all
    assert all(np.isfinite(runs[0].train_all))
    assert port_trainer.batch_seed(0, 1, 0, 2) == port_trainer.batch_seed(0, 1, 0, 2)
    assert len({port_trainer.batch_seed(0, e, s, i)
                for e in range(3) for s in range(2) for i in range(4)}) == 24


def test_checkpoint_round_trip_and_resume(tmp_path):
    ds = SmokeDS()
    tr = small_trainer(tmp_path / "m")
    tr.train(ds, epochs=1)
    for name in (checkpoint.BEST, checkpoint.LAST):
        assert checkpoint.exists(os.path.join(str(tmp_path / "m"), name))
    saved = [t.detach().clone() for t in tr.params.tensors()]
    opt_saved = tr.optimizer.state_dict()

    tr2 = small_trainer(tmp_path / "m")
    restored = tr2.restore(checkpoint.LAST)
    for a, b in zip(restored.tensors(), saved):
        assert torch.equal(a.detach(), b) and a.requires_grad
    assert tr2.optimizer.state_dict()["state"][0]["step"] == opt_saved["state"][0]["step"]
    assert torch.equal(tr2.optimizer.state_dict()["state"][3]["exp_avg"],
                       opt_saved["state"][3]["exp_avg"])

    tr2.train(ds, epochs=1, retrain=True)
    assert int(tr2.optimizer.state_dict()["state"][0]["step"]) == 2 * 4  # 4 steps per epoch
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(tr2.params.tensors(), saved))
    assert moved > 0


def test_nonfinite_guard_skips_and_counts(tmp_path):
    ds = SmokeDS()
    tr = small_trainer(tmp_path / "g", skip_nonfinite_updates=True)
    tr.init_state()
    u, y = (torch.as_tensor(a[:8]) for a in (ds.train_in_batch, ds.train_out_batch))
    w = torch.ones(8, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    _, applied = tr.train_step(u, y, w, gen)
    assert applied
    before = [t.detach().clone() for t in tr.params.tensors()]
    opt_before = tr.optimizer.state_dict()
    opt_before = {k: {n: v.clone() for n, v in s.items()} for k, s in opt_before["state"].items()}
    y_bad = y.clone()
    y_bad[0, 3, 0] = float("nan")
    loss, applied = tr.train_step(u, y_bad, w, torch.Generator().manual_seed(1))
    assert not applied and not torch.isfinite(loss)
    for a, b in zip(tr.params.tensors(), before):
        assert torch.equal(a.detach(), b)
    for k, s in tr.optimizer.state_dict()["state"].items():
        for n, v in s.items():
            assert torch.equal(v, opt_before[k][n]), (k, n)
    # in a training run the skip is counted and reported
    ds_bad = SmokeDS()
    ds_bad.train_out_batch = ds_bad.train_out_batch.copy()
    ds_bad.train_out_batch[5, 0, 0] = np.nan  # not window 0: pad rows gather it
    tr.train(ds_bad, epochs=1)
    assert tr.skipped_steps == 1 and not np.isfinite(tr.train_all[0])


def test_guard_flag_must_be_bool():
    with pytest.raises(ValueError, match="skip_nonfinite_updates"):
        CBFSSM(dict(smoke_config(), skip_nonfinite_updates="yes"), device="cpu")


def test_metrics_events(tmp_path):
    ds = SmokeDS()
    path = tmp_path / "metrics.jsonl"
    model = CBFSSM(smoke_config(), device="cpu")
    Trainer(model, str(tmp_path / "m"), metrics_path=str(path)).train(ds, epochs=2)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["event"] for ln in lines] == ["epoch", "epoch", "done"]
    assert [ln["epoch"] for ln in lines[:2]] == [0, 1]
    assert all(ln["steps_per_sec"] > 0 and np.isfinite(ln["train_loss"]) for ln in lines[:2])
    assert lines[2]["epochs"] == 2 and lines[2]["best_train"] == min(ln["train_loss"]
                                                                     for ln in lines[:2])


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": object()}, "A6.1"),
])
def test_trainer_rejects_what_is_not_ported(tmp_path, kwargs, match):
    with pytest.raises(ValueError, match=match):
        Trainer(CBFSSM(smoke_config(), device="cpu"), str(tmp_path / "m"), **kwargs)


def test_profile_dir_traces_epoch_1_with_unchanged_losses(tmp_path):
    """``profile_dir`` writes one torch.profiler trace of epoch 1's
    training and leaves every loss as it is without it."""
    ds = SmokeDS()
    losses = {}
    for name, kwargs in (("plain", {}), ("traced", {"profile_dir": str(tmp_path / "trace")})):
        trainer = Trainer(CBFSSM(smoke_config(), device="cpu"), str(tmp_path / name), **kwargs)
        trainer.train(ds, epochs=2)
        losses[name] = (trainer.train_all, trainer.test_all)
    assert losses["traced"] == losses["plain"]
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)


def test_async_saver_latest_wins_and_snapshots_on_caller_thread(tmp_path):
    saver = checkpoint.AsyncSaver()
    path = str(tmp_path / "ck")
    arr = torch.ones(4)
    saver.save(path, {"w": arr})
    arr[:] = -7.0  # mutated after submission: must not reach the file
    saver.flush()
    assert torch.equal(checkpoint.restore(path)["w"], torch.ones(4))
    for k in range(5):
        saver.save(path, {"w": torch.full((3,), float(k))})
    saver.flush()
    assert torch.equal(checkpoint.restore(path)["w"], torch.full((3,), 4.0))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_async_saver_flush_reraises_scoped_by_prefix(tmp_path, monkeypatch):
    saver = checkpoint.AsyncSaver()
    real_write = checkpoint._write

    def flaky(path, tree):
        if "m10" in path:
            raise OSError(f"injected for {path}")
        real_write(path, tree)

    monkeypatch.setattr(checkpoint, "_write", flaky)
    saver.save(os.path.join(str(tmp_path / "m10"), "best.ckpt"), {"w": torch.zeros(2)})
    saver.save(os.path.join(str(tmp_path / "m1"), "best.ckpt"), {"w": torch.ones(2)})
    saver.flush(str(tmp_path / "m1"))  # m10's error is not m1's
    with pytest.raises(OSError, match="m10"):
        saver.flush(str(tmp_path / "m10"))
    saver.flush()  # nothing left
    assert checkpoint.shared_saver() is checkpoint.shared_saver()


@pytest.mark.parametrize("warmup", [0, 1, 2])
def test_step_timer_discards_warmup(warmup, monkeypatch):
    clock = iter(float(t) for t in range(100))
    monkeypatch.setattr("cbfssm_tpu_torch.utils.profiling.time.perf_counter", lambda: next(clock))
    timer = StepTimer(warmup=warmup)
    assert timer.steps_per_sec is None
    for _ in range(warmup + 3):
        timer.tick()
    # clock reads: start (at construction or the warmup-th tick), then
    # one read by steps_per_sec; 3 timed steps over that span
    rate = timer.steps_per_sec
    assert rate is not None and rate > 0
