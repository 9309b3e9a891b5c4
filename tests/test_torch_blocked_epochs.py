"""Fused multi-epoch dispatch (``epochs_per_dispatch``) in the port's
trainers (tests/test_trainer.py:91, 124, tests/test_multiseed.py:158,
tests/test_nonfinite_guard.py:106, 133 for the port).

A block of k epochs is issued with no host read, its running best chained
on the device, and the host reads block k back after issuing block k+1.
Pinned here, on tests/test_trainer.SmokeDS's windows:

- ``resolve_epochs_per_dispatch`` equals the JAX package's over a grid
  (with tests/test_trainer.py:124-138's cases), and ``_resolve_epd``
  gives 1 under ``profile_dir``;
- ``Trainer`` at epd 2 against epd 1 over 5 epochs (two blocks and a
  tail), with and without the non-finite guard on a poisoned batch:
  losses, skip counts and the best and last checkpoints bitwise equal;
  likewise ``MultiSeedTrainer`` and ``SweepTrainer`` (stacked and single
  checkpoints);
- inside a block nothing reads a tensor back to the host (``item``,
  ``bool``, ``float``, ``tolist``, ... raise there);
- the Trainer's Adam step (the lanes' update, its count on the device)
  tracks ``torch.optim.Adam``'s step, the update before blocks, at the
  JAX comparisons' rtol 1e-6 (not bitwise: the two round differently);
- each epoch is logged with its own time (C10: a block's epochs counted
  the next block's issue too);
- an invalid value raises. The blocked ``Trainer`` on a 2-rank mesh is a
  case of tests/test_torch_distributed.py's rank group; the card's twins
  are the ``cuda`` tests at the end (the sync debug mode in error there).
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.training import MultiSeedTrainer, SweepTrainer, Trainer, checkpoint
from cbfssm_tpu_torch.training import multiseed
from cbfssm_tpu_torch.training.trainer import resolve_epochs_per_dispatch
import torch_parallel_workers as workers  # tests/ (pytest puts it on sys.path)
from test_torch_distributed import smoke_arrays, smoke_config

EPOCHS = 5  # two blocks of 2 and a per-epoch tail
READS = ("item", "tolist", "numpy", "__bool__", "__float__", "__int__", "__index__")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its steps are many
    tiny ops, which 8 threads in each of the suite's 6 workers slow
    twenty-fold (the numbers do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds():
    return workers.Windows(**smoke_arrays())


@pytest.fixture(scope="module")
def poisoned(ds):
    """One NaN window: every epoch's mean is NaN and one batch an epoch
    is skipped (tests/test_nonfinite_guard.py's _poisoned_ds)."""
    arrays = {k: getattr(ds, k).copy() for k in ("train_in_batch", "train_out_batch",
                                                  "test_in_batch", "test_out_batch")}
    arrays["train_out_batch"][5, 0, 0] = np.nan
    return workers.Windows(**arrays)


def model(device="cpu", **overrides):
    return CBFSSM(smoke_config(**overrides), device=device)


def assert_trees_equal(a, b, where=""):
    """Two checkpoint trees (nested dicts / lists of tensors and plain
    values) equal leaf for leaf, bitwise."""
    fa, spec_a = torch.utils._pytree.tree_flatten(a)
    fb, spec_b = torch.utils._pytree.tree_flatten(b)
    assert spec_a == spec_b, where
    for x, y in zip(fa, fb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), where
        else:
            assert x == y, where


def assert_checkpoints_equal(dir_a, dir_b, names):
    for name in names:
        path_a, path_b = os.path.join(dir_a, name), os.path.join(dir_b, name)
        assert os.path.exists(path_a) == os.path.exists(path_b), name
        if os.path.exists(path_a):
            assert_trees_equal(checkpoint.restore(path_a), checkpoint.restore(path_b), name)


def count_blocks(monkeypatch, cls):
    """Count ``cls._dispatch_block`` calls."""
    calls = []
    dispatch = cls._dispatch_block

    def counted(self, *args):
        calls.append(args)
        return dispatch(self, *args)

    monkeypatch.setattr(cls, "_dispatch_block", counted)
    return calls


# --- resolution ----------------------------------------------------------------


def test_resolution_equals_jax():
    pytest.importorskip("flax")
    from cbfssm_tpu.training.trainer import resolve_epochs_per_dispatch as jax_resolve

    for epd in ("auto", 1, 2, 3, 7, 19, 64, 100, 0, -2):
        for steps in (0, 1, 2, 4, 10, 16, 150, 300, 400, 1000):
            for epochs in (0, 1, 2, 4, 5, 1000):
                assert resolve_epochs_per_dispatch(epd, steps, epochs) == \
                    jax_resolve(epd, steps, epochs), (epd, steps, epochs)


def test_resolve_epd_auto_profile_and_pinned(tmp_path):
    """tests/test_trainer.py:124-138 on the port's Trainer."""
    tr = Trainer(model(), str(tmp_path / "epd"))
    assert tr._resolve_epd(steps_per_epoch=10, epochs=1000) == 30
    assert tr._resolve_epd(steps_per_epoch=400, epochs=1000) == 1
    assert tr._resolve_epd(steps_per_epoch=1, epochs=1000) == 64
    assert tr._resolve_epd(steps_per_epoch=10, epochs=4) == 4
    prof = Trainer(model(), str(tmp_path / "epd"), profile_dir=str(tmp_path / "trace"))
    assert prof._resolve_epd(steps_per_epoch=10, epochs=1000) == 1
    pinned = Trainer(model(), str(tmp_path / "epd"), epochs_per_dispatch=7)
    assert pinned._resolve_epd(steps_per_epoch=10, epochs=1000) == 7
    from_config = Trainer(model(epochs_per_dispatch=3), str(tmp_path / "epd"))
    assert from_config._resolve_epd(steps_per_epoch=10, epochs=1000) == 3
    lanes = MultiSeedTrainer(model(), str(tmp_path / "ms"), n_seeds=2, epochs_per_dispatch=5)
    assert lanes._resolve_epd(steps_per_epoch=10, epochs=1000) == 5


@pytest.mark.parametrize("bad", ["fast", 2.0, True])
def test_invalid_values_raise(tmp_path, bad):
    with pytest.raises(ValueError, match="epochs_per_dispatch"):
        model(epochs_per_dispatch=bad)
    with pytest.raises(ValueError, match="epochs_per_dispatch"):
        Trainer(model(), str(tmp_path), epochs_per_dispatch=bad)
    with pytest.raises(ValueError, match="epochs_per_dispatch"):
        MultiSeedTrainer(model(), str(tmp_path), n_seeds=2, epochs_per_dispatch=bad)


# --- Trainer ---------------------------------------------------------------------


def train_pair(tmp_path, ds, make, epochs=EPOCHS):
    """``make(path, epd)`` trained at epd 1 and 2: {epd: (trainer, dir)}."""
    runs = {}
    for epd in (1, 2):
        path = str(tmp_path / f"epd{epd}")
        tr = make(path, epd)
        tr.train(ds, epochs=epochs)
        runs[epd] = (tr, path)
    return runs


@pytest.mark.parametrize("guard", [False, True])
def test_trainer_blocked_equals_per_epoch(tmp_path, monkeypatch, ds, poisoned, guard):
    blocks = count_blocks(monkeypatch, Trainer)
    runs = train_pair(tmp_path, poisoned if guard else ds, lambda path, epd: Trainer(
        model(skip_nonfinite_updates=guard), path, seed=3, epochs_per_dispatch=epd))
    (seq, seq_dir), (blk, blk_dir) = runs[1], runs[2]
    assert len(blocks) == 2  # the epd-2 run: epochs (0, 1), (2, 3), then the tail
    np.testing.assert_array_equal(seq.train_all, blk.train_all)
    np.testing.assert_array_equal(seq.test_all, blk.test_all)
    assert np.isfinite(seq.test_all).all()
    if guard:
        assert seq.skipped_steps == blk.skipped_steps == EPOCHS
        assert not np.isfinite(seq.train_all).any()  # the guard protects the state
        assert all(torch.isfinite(t).all() for t in blk.params.tensors())
    else:
        assert blk.train_all[-1] < blk.train_all[0]
    assert_checkpoints_equal(seq_dir, blk_dir, (checkpoint.BEST, checkpoint.LAST))
    assert os.path.exists(os.path.join(blk_dir, checkpoint.BEST)) != guard
    for a, b in zip(seq.params.tensors(), blk.params.tensors()):
        assert torch.equal(a, b)


def test_default_auto_runs_blocks(tmp_path, monkeypatch, ds):
    """'auto' on SmokeDS (4 steps an epoch) resolves to the run's 2
    epochs: one block, equal to the per-epoch run."""
    blocks = count_blocks(monkeypatch, Trainer)
    runs = train_pair(tmp_path, ds, lambda path, epd: Trainer(
        model(), path, seed=1, epochs_per_dispatch=None if epd == 2 else 1), epochs=2)
    assert [args[2:] for args in blocks] == [(0, 2, float("inf"))]
    assert runs[1][0].train_all == runs[2][0].train_all
    assert_checkpoints_equal(runs[1][1], runs[2][1], (checkpoint.BEST, checkpoint.LAST))


@contextlib.contextmanager
def no_host_reads(monkeypatch, cls, allowed=lambda self, t: False):
    """Make every read of a tensor to the host raise while
    ``cls._dispatch_block`` runs, except those ``allowed(trainer,
    tensor)``. Yields the list of blocks issued."""
    inside = []
    blocks = []
    dispatch = cls._dispatch_block

    def guarded(self, *args):
        inside.append(self)
        try:
            blocks.append(args)
            return dispatch(self, *args)
        finally:
            inside.pop()

    for name in READS:
        original = getattr(torch.Tensor, name)

        def read(t, *args, _name=name, _original=original, **kwargs):
            if inside and not allowed(inside[-1], t):
                raise AssertionError(f"Tensor.{_name} inside a block")
            return _original(t, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, read)
    monkeypatch.setattr(cls, "_dispatch_block", guarded)
    yield blocks
    monkeypatch.undo()


@pytest.mark.parametrize("guard", [False, True])
def test_trainer_block_reads_nothing_back(tmp_path, monkeypatch, ds, guard):
    with no_host_reads(monkeypatch, Trainer) as blocks:
        tr = Trainer(model(skip_nonfinite_updates=guard), str(tmp_path), seed=0,
                     epochs_per_dispatch=2)
        tr.train(ds, epochs=4)
    assert len(blocks) == 2 and len(tr.train_all) == 4


def test_multiseed_block_reads_nothing_back(tmp_path, monkeypatch, ds):
    with no_host_reads(monkeypatch, MultiSeedTrainer) as blocks:
        tr = MultiSeedTrainer(model(skip_nonfinite_updates=True), str(tmp_path), n_seeds=2,
                              seed=1, epochs_per_dispatch=2)
        tr.train(ds, epochs=2)
    assert len(blocks) == 1 and len(tr.train_all) == 2


class TorchAdamTrainer(Trainer):
    """The Trainer stepped by ``torch.optim.Adam`` itself, the guard
    deciding on the host: the update the port ran before blocks."""

    def _adam_update(self, leaves, ok=None):
        if ok is None or bool(ok):
            self.optimizer.step()


@pytest.mark.parametrize("guard", [False, True])
def test_trainer_adam_tracks_torch_adam(tmp_path, ds, poisoned, guard):
    """Per-epoch losses, final params and the best and last checkpoints
    of the Trainer against ``TorchAdamTrainer`` over 5 epochs at rtol
    1e-6 (tests/test_torch_train.py's tolerance against the JAX
    trainer): the step count and the skip agree exactly."""
    runs = []
    for cls in (Trainer, TorchAdamTrainer):
        path = str(tmp_path / cls.__name__)
        tr = cls(model(skip_nonfinite_updates=guard), path, seed=3, epochs_per_dispatch=1)
        tr.train(poisoned if guard else ds, epochs=EPOCHS)
        runs.append((tr, path))
    (got, got_dir), (want, want_dir) = runs
    np.testing.assert_allclose(got.train_all, want.train_all, rtol=1e-6)
    np.testing.assert_allclose(got.test_all, want.test_all, rtol=1e-6)
    assert got.skipped_steps == want.skipped_steps
    for a, b in zip(got.params.tensors(), want.params.tensors()):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6, atol=1e-12)
    for name in (checkpoint.BEST, checkpoint.LAST):
        assert os.path.exists(os.path.join(got_dir, name)) == \
            os.path.exists(os.path.join(want_dir, name))
        if not os.path.exists(os.path.join(got_dir, name)):
            continue
        a = checkpoint.restore(os.path.join(got_dir, name))
        b = checkpoint.restore(os.path.join(want_dir, name))
        for x, y in zip(a["params"], b["params"]):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-12)
        for i, state in b["opt_state"]["state"].items():
            assert float(a["opt_state"]["state"][i]["step"]) == float(state["step"])
            for key in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(a["opt_state"]["state"][i][key], state[key],
                                           rtol=1e-6, atol=1e-12)


# --- lanes -------------------------------------------------------------------------

LANE_CKPTS = (checkpoint.BEST, checkpoint.LAST, multiseed.BEST_SEEDS, multiseed.LAST_SEEDS)


def assert_lane_runs_equal(runs):
    (seq, seq_dir), (blk, blk_dir) = runs[1], runs[2]
    np.testing.assert_array_equal(np.stack(seq.train_all), np.stack(blk.train_all))
    np.testing.assert_array_equal(np.stack(seq.test_all), np.stack(blk.test_all))
    np.testing.assert_array_equal(seq.best_loss, blk.best_loss)
    assert seq.skipped_steps == blk.skipped_steps
    for a, b in zip(seq.best_params + seq.params.tensors(), blk.best_params + blk.params.tensors()):
        assert torch.equal(a, b)
    assert_checkpoints_equal(seq_dir, blk_dir, LANE_CKPTS)


@pytest.mark.parametrize("guard,epochs", [(False, EPOCHS), (True, 3)])
def test_multiseed_blocked_equals_per_epoch(tmp_path, monkeypatch, ds, poisoned, guard, epochs):
    blocks = count_blocks(monkeypatch, MultiSeedTrainer)
    runs = train_pair(tmp_path, poisoned if guard else ds, lambda path, epd: MultiSeedTrainer(
        model(skip_nonfinite_updates=guard), path, n_seeds=2, seed=1,
        epochs_per_dispatch=epd), epochs=epochs)
    assert len(blocks) == epochs // 2
    assert_lane_runs_equal(runs)
    if guard:
        assert runs[2][0].skipped_steps == 2 * epochs  # one batch an epoch, each lane
        assert all(torch.isfinite(t).all() for t in runs[2][0].params.tensors())


def test_sweep_blocked_equals_per_epoch(tmp_path, monkeypatch, ds):
    blocks = count_blocks(monkeypatch, SweepTrainer)
    runs = train_pair(tmp_path, ds, lambda path, epd: SweepTrainer(
        CBFSSM, smoke_config(), {"k_factor": [10.0, 50.0]}, path, seed=0, device="cpu",
        epochs_per_dispatch=epd), epochs=3)
    assert len(blocks) == 1
    assert_lane_runs_equal(runs)
    assert runs[1][0].best_config() == runs[2][0].best_config()


# --- on the card -------------------------------------------------------------------


class FakeClock:
    """``time`` for the trainers' modules: ``perf_counter`` reads a clock
    that each issued training epoch advances by one second."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.mark.parametrize("cls", [Trainer, MultiSeedTrainer])
def test_logged_epoch_seconds_sum_to_the_run(tmp_path, monkeypatch, ds, cls):
    """C10: a block's epochs are logged with its own time over k. The
    host reads block k back after it issued block k+1, and issuing is
    the work here (and on a host-bound card), so the time to the
    read-back counted block k+1 too: 2 s an epoch where each took 1 s,
    and the logged seconds of a run summed to more than its wall time."""
    clock = FakeClock()
    monkeypatch.setattr(sys.modules[cls.__module__], "time", clock)
    kwargs = {"n_seeds": 2} if cls is MultiSeedTrainer else {}
    trainer = cls(model(), str(tmp_path / "run"), epochs_per_dispatch=2, **kwargs)
    train_epoch, log_epoch = trainer._epoch_train, trainer._log_epoch
    if cls is Trainer:
        train_epoch = trainer._train_epoch
    seconds = []

    def timed_epoch(*args):
        clock.now += 1.0
        return train_epoch(*args)

    def logged(epoch, train, test, dt, *args):
        seconds.append(dt)
        return log_epoch(epoch, train, test, dt, *args)

    setattr(trainer, "_train_epoch" if cls is Trainer else "_epoch_train", timed_epoch)
    trainer._log_epoch = logged
    trainer.train(ds, EPOCHS)
    assert seconds == [1.0] * EPOCHS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@contextlib.contextmanager
def sync_errors(monkeypatch, cls):
    """``torch.cuda.set_sync_debug_mode('error')`` while
    ``cls._dispatch_block`` runs: a host sync inside a block raises."""
    dispatch = cls._dispatch_block

    def strict(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(cls, "_dispatch_block", strict)
    yield


@pytest.mark.cuda
@pytest.mark.parametrize("guard", [False, True])
def test_cuda_trainer_blocks_equal_per_epoch_without_a_sync(cuda_device, tmp_path, monkeypatch,
                                                            ds, guard):
    """The kernel path on the card: epd 2 against epd 1, bitwise, and no
    host sync inside a block; the residual kernel launched as often in
    both."""
    from cbfssm_tpu_torch.ops import fused_predict as fp

    launches = []

    def make(path, epd):
        launches.append(fp.fused_predict_residuals.launches)
        return Trainer(model("cuda", gp_impl="pallas", skip_nonfinite_updates=guard), path,
                       seed=3, epochs_per_dispatch=epd)

    with sync_errors(monkeypatch, Trainer):
        runs = train_pair(tmp_path, ds, make)
    launches.append(fp.fused_predict_residuals.launches)
    assert launches[1] - launches[0] == launches[2] - launches[1] > 0
    (seq, seq_dir), (blk, blk_dir) = runs[1], runs[2]
    assert seq.train_all == blk.train_all and seq.test_all == blk.test_all
    assert_checkpoints_equal(seq_dir, blk_dir, (checkpoint.BEST, checkpoint.LAST))


@pytest.mark.cuda
def test_cuda_multiseed_blocks_equal_per_epoch_without_a_sync(cuda_device, tmp_path, monkeypatch,
                                                              ds):
    with sync_errors(monkeypatch, MultiSeedTrainer):
        runs = train_pair(tmp_path, ds, lambda path, epd: MultiSeedTrainer(
            model("cuda", gp_impl="pallas"), path, n_seeds=2, seed=1, epochs_per_dispatch=epd),
            epochs=3)
    assert_lane_runs_equal(runs)
