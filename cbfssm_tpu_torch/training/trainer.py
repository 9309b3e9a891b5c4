"""Training loop (port of ``cbfssm_tpu/training/trainer.py``).

Per epoch: a shuffled pass over the window batches with one Adam step
per batch (the loss is a weighted sum within a batch; the ragged last
batch is padded with index 0 at weight 0), then the test-set loss with
``condition=True``, one stdout line, ``metrics.jsonl`` events, a best
checkpoint whenever the train loss improves and the last checkpoint at
the end; ``retrain=True`` resumes from the last checkpoint.

The JAX package runs an epoch (or a block of epochs) as one device
program; its block dispatch is pinned to give the losses of per-epoch
dispatch, so this port runs epoch by epoch, in eager PyTorch, and gets
the same numbers (the model accepts only ``epochs_per_dispatch='auto'``).
Not ported: device meshes (``mesh``, ROADMAP A6.1), the profiler trace
(``profile_dir``, A6.3), and the model directory's self-description for
the CLI (``model_store.save_model_meta`` / ``record_dataset``, A4.2).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from cbfssm_tpu_torch.training import checkpoint
from cbfssm_tpu_torch.utils.profiling import MetricsLogger


def epoch_indices(rng, n, batch_size, shuffle: bool, dtype):
    """[n_batches, B] gather indices + pad weights for one epoch: a
    (shuffled) permutation of ``n`` window indices, zero-padded to full
    batches with zero weights (the loss is a weighted sum, so padding
    contributes nothing)."""
    idx = rng.permutation(n) if shuffle else np.arange(n)
    n_batches = -(-n // batch_size)
    padded = np.zeros(n_batches * batch_size, dtype=np.int32)
    padded[:n] = idx
    weights = np.zeros(n_batches * batch_size, dtype=np.float32)
    weights[:n] = 1.0
    return (
        padded.reshape(n_batches, batch_size),
        weights.reshape(n_batches, batch_size).astype(dtype),
    )


def batch_seed(seed: int, epoch: int, split: int, i: int) -> int:
    """The seed of batch ``i`` of ``split`` (0 train, 1 test) in
    ``epoch``: a function of the four numbers alone, as the JAX trainer's
    ``fold_in(fold_in(fold_in(PRNGKey(seed + 1), epoch), split), i)``
    key is (the numbers drawn differ: Philox, not threefry)."""
    entropy = [seed + 1, epoch, split, i]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


class Trainer:
    """Trains ``model`` (a ``CBFSSM``, ``CBFSSMHALF`` or ``PRSSM``) on
    its device with Adam.

    ``seed`` fixes the init params (``model.init``), the shuffles
    (``np.random.default_rng(seed)``, as in the JAX trainer) and the
    rollout noise of every batch (:func:`batch_seed`). Two test seams
    inject what the JAX trainer draws inside: ``init_params`` replaces
    ``model.init`` (e.g. the converted JAX init), and
    ``noise_fn(epoch, split, i, b, t_len) -> noise | None`` replaces the
    rollout's draws (the model's ``noise=``: a ``RolloutNoise`` for
    CBFSSM, a ``[T-1, B, S, 1]`` tensor for the others).
    """

    def __init__(self, model, model_dir, mesh=None, seed=0, metrics_path=None,
                 profile_dir=None, init_params=None, noise_fn=None):
        if mesh is not None:
            raise ValueError("Trainer(mesh=...) is not ported (ROADMAP A6.1)")
        if profile_dir is not None:
            raise ValueError("Trainer(profile_dir=...) is not ported (ROADMAP A6.3)")
        self.model = model
        self.model_dir = model_dir
        self.device = model.device
        self.seed = seed
        self.train_all = []
        self.test_all = []
        self.params = None
        self.optimizer = None
        self._rng = np.random.default_rng(seed)
        self.metrics = MetricsLogger(metrics_path)
        self.saver = checkpoint.shared_saver()
        self._guard = bool(model.config.skip_nonfinite_updates)
        self.skipped_steps = 0  # cumulative non-finite batches skipped
        self._last_skipped = 0
        self._init_params = init_params
        self._noise_fn = noise_fn
        self._device_data = {}
        os.makedirs(model_dir, exist_ok=True)

    # --- state -----------------------------------------------------------

    def _fresh_state(self):
        """Init params as leaves that require grad, and a new Adam with
        optax's ``adam`` defaults."""
        if self._init_params is not None:
            params = self._init_params.to(device=self.device, dtype=self.model.dtype)
        else:
            params = self.model.init(torch.Generator(device=self.device).manual_seed(self.seed))
        leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
        self.params = params.with_tensors(leaves)
        self.optimizer = torch.optim.Adam(
            leaves, lr=float(self.model.config.learning_rate), betas=(0.9, 0.999), eps=1e-8
        )

    def _load(self, name: str):
        tree = checkpoint.restore(os.path.join(self.model_dir, name), map_location=self.device)
        leaves = self.params.tensors()
        if len(tree["params"]) != len(leaves):
            raise ValueError(f"{name} holds {len(tree['params'])} params, the model {len(leaves)}")
        with torch.no_grad():
            for leaf, saved in zip(leaves, tree["params"]):
                leaf.copy_(saved)
        self.optimizer.load_state_dict(tree["opt_state"])

    def init_state(self, retrain: bool = False):
        self._fresh_state()
        if retrain:
            self.saver.flush(self.model_dir)  # pending writes must land first
            self._load(checkpoint.LAST)

    def restore(self, name: str = checkpoint.BEST):
        """Load a checkpoint into the trainer's state; returns params."""
        self.saver.flush(self.model_dir)  # pending writes must land first
        self._fresh_state()
        self._load(name)
        return self.params

    def _save(self, name: str):
        self.saver.save(
            os.path.join(self.model_dir, name),
            {"params": [t.detach() for t in self.params.tensors()],
             "opt_state": self.optimizer.state_dict()},
        )

    # --- batching ----------------------------------------------------------

    def _stage(self, tag, data_in, data_out):
        """The windowed dataset on the model's device, once per train()."""
        if tag not in self._device_data:
            kw = dict(dtype=self.model.dtype, device=self.device)
            self._device_data[tag] = (torch.as_tensor(np.asarray(data_in), **kw),
                                      torch.as_tensor(np.asarray(data_out), **kw))
        return self._device_data[tag]

    def _epoch_indices(self, n, batch_size, shuffle: bool):
        return epoch_indices(self._rng, n, batch_size, shuffle, self.model.np_dtype)

    def _batches(self, data_u, data_y, batch_size, shuffle, epoch, split):
        """(u, y, weights, generator, noise) of each batch of an epoch."""
        idx, w = self._epoch_indices(data_u.shape[0], batch_size, shuffle)
        idx_d = torch.as_tensor(idx.astype(np.int64), device=self.device)
        w_d = torch.as_tensor(w, device=self.device)
        t_len = data_u.shape[1]
        for i in range(idx.shape[0]):
            noise = None
            if self._noise_fn is not None:
                noise = self._noise_fn(epoch, split, i, batch_size, t_len)
            gen = None
            if noise is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(batch_seed(self.seed, epoch, split, i))
            yield data_u[idx_d[i]], data_y[idx_d[i]], w_d[i], gen, noise

    def train_step(self, u, y, weights, generator=None, noise=None):
        """One Adam step on one batch; returns ``(loss, applied)`` with
        the loss a detached 0-d tensor. With ``skip_nonfinite_updates``
        a batch whose loss or any gradient is not finite leaves params
        and optimizer state (moments and step count) unchanged."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.model.loss(self.params, u, y, generator, True, weights, noise)
        loss.backward()
        leaves = self.params.tensors()
        for p in leaves:
            if p.grad is None:  # a leaf the loss does not reach: zero, as in JAX
                p.grad = torch.zeros_like(p)
        if self._guard:
            ok = torch.isfinite(loss)
            for p in leaves:
                ok = ok & torch.isfinite(p.grad).all()
            if not bool(ok):
                return loss.detach(), False
        self.optimizer.step()
        return loss.detach(), True

    def _epoch_train(self, ds, batch_size, epoch):
        data_u, data_y = self._stage("train", ds.train_in_batch, ds.train_out_batch)
        losses, skipped = [], 0
        for u, y, w, gen, noise in self._batches(data_u, data_y, batch_size, True, epoch, 0):
            loss, applied = self.train_step(u, y, w, gen, noise)
            losses.append(loss)
            skipped += not applied
        if self._guard:
            self._note_skipped(skipped)
        return float(torch.stack(losses).mean())

    @torch.no_grad()
    def _epoch_eval(self, ds, batch_size, epoch):
        data_u, data_y = self._stage("test", ds.test_in_batch, ds.test_out_batch)
        losses = [
            self.model.loss(self.params, u, y, gen, True, w, noise)[0]
            for u, y, w, gen, noise in self._batches(data_u, data_y, batch_size, False, epoch, 1)
        ]
        return float(torch.stack(losses).mean())

    def _note_skipped(self, skipped: int):
        self._last_skipped = skipped
        if skipped:
            self.skipped_steps += skipped
            print(f"  [guard] skipped {skipped} non-finite batch update(s) this epoch",
                  file=sys.stderr)

    # --- main loop -----------------------------------------------------------

    def _log_epoch(self, epoch, train_loss, test_loss, dt, steps_per_epoch):
        print(
            "[{epoch:04}]: Train {train}, Test {test}  ({dt:.2f}s)".format(
                epoch=epoch, train=train_loss, test=test_loss, dt=dt
            )
        )
        self.train_all.append(train_loss)
        self.test_all.append(test_loss)
        extra = {"skipped_steps": self._last_skipped} if self._guard else {}
        self.metrics.log(
            event="epoch", epoch=epoch, train_loss=train_loss, test_loss=test_loss,
            seconds=dt, steps_per_sec=steps_per_epoch / dt, **extra,
        )

    def train(self, ds, epochs: int, retrain: bool = False):
        print("\nTraining...\n")
        self.init_state(retrain)
        self._device_data = {}
        batch_size = int(self.model.config.batch_size)
        steps_per_epoch = -(-ds.train_in_batch.shape[0] // batch_size)
        lowest_train = float("inf")
        for epoch in range(epochs):
            t0 = time.perf_counter()
            train_loss = self._epoch_train(ds, batch_size, epoch)
            test_loss = self._epoch_eval(ds, batch_size, epoch)
            self._log_epoch(epoch, train_loss, test_loss, time.perf_counter() - t0,
                            steps_per_epoch)
            if train_loss < lowest_train:
                self._save(checkpoint.BEST)
                lowest_train = train_loss
        self._save(checkpoint.LAST)
        self.saver.flush(self.model_dir)
        done_extra = {"skipped_steps": self.skipped_steps} if self._guard else {}
        self.metrics.log(event="done", epochs=epochs, best_train=lowest_train, **done_extra)
