"""Multi-seed training: N independent replicates as one lane-batched
program (port of ``cbfssm_tpu/training/multiseed.py``).

The reference reproduces a result by training 5 seeds one after the
other. The JAX package runs them as one ``jax.vmap`` program over a
leading seed axis; so does this port, with ``torch.func.vmap`` over the
model's own ``loss`` / ``predict``: every parameter leaf is stacked on a
leading lane axis ``[L, ...]`` (``params.tensors()`` around the vmap,
``params.with_tensors()`` inside it), and each op of a step is issued
once for all lanes. The fused GP predict then runs its lane kernels
(``gp_predict_residuals_lanes`` in a training step, ``gp_predict_lanes``
in the test loss and :meth:`MultiSeedTrainer.evaluate_rmse`), one launch
for all lanes. Gradients are ordinary autograd: ``losses.sum()
.backward()`` on the stacked leaves gives each lane exactly its own
gradient, since lanes share nothing.

Random numbers. Each lane has its own init, shuffle and rollout noise,
drawn outside the vmap and passed in stacked:

- init: lane ``l`` draws ``model.init`` from a generator seeded
  :func:`init_seed` ``(seed, l)``;
- shuffles: one ``np.random.default_rng(seed)``, each epoch one
  permutation per lane in lane order (the JAX trainer's order, so the
  indices are the JAX package's);
- noise: batch ``i`` of ``split`` (0 train, 1 test) in ``epoch`` draws
  ``model.draw_noise`` from a generator seeded :func:`lane_batch_seed`
  ``(seed, epoch, split, l, i)``: the port's ``batch_seed`` with the lane
  folded in before the batch, where the JAX trainer folds it in by
  splitting the epoch key over the lanes. The numbers are Philox's, not
  threefry's.

Optimizer. One Adam over the stacked leaves (:class:`LaneAdam`): optax's
defaults and ``torch.optim.Adam``'s update, with a step count and a
learning rate per lane. With ``skip_nonfinite_updates`` the guard acts
per lane, as ``apply_update_guarded`` does in the JAX package: a lane
whose loss or gradient is not finite keeps its params, moments and step
count, and the other lanes train as if it were not there.

Checkpoints: ``best_seeds.ckpt`` / ``model_seeds.ckpt`` hold the stacked
params and optimizer (resume with ``retrain=True``); ``best.ckpt`` /
``model.ckpt`` hold the best lane's unstacked tree in the single-model
``Trainer``'s format, so ``Trainer.restore`` and ``Outputs`` load them.

Not ported: device meshes (``mesh``, ROADMAP A6.1), fused multi-epoch
dispatch (``epochs_per_dispatch`` other than 'auto', an A4.1 follow-up),
both rejected with a ``ValueError``; and the model directory's
self-description for the CLI (``model_store`` snapshots, A4.2), which is
not written.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch
from torch.func import vmap

from cbfssm_tpu_torch.training import checkpoint
from cbfssm_tpu_torch.training.trainer import epoch_indices
from cbfssm_tpu_torch.utils.profiling import MetricsLogger

# Stacked [n_seeds, ...] checkpoints get their own names, so that a
# single-model consumer never loads a stacked tree by accident.
BEST_SEEDS = "best_seeds.ckpt"
LAST_SEEDS = "model_seeds.ckpt"

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _seed(entropy) -> int:
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def init_seed(seed: int, lane: int) -> int:
    """The seed of lane ``lane``'s init generator."""
    return _seed([seed, lane])


def lane_batch_seed(seed: int, epoch: int, split: int, lane: int, i: int) -> int:
    """The seed of lane ``lane``'s noise for batch ``i`` of ``split`` (0
    train, 1 test) in ``epoch``."""
    return _seed([seed + 1, epoch, split, lane, i])


def stack_noise(noises: list) -> list:
    """One stacked ``[L, ...]`` tensor per field of the lanes' rollout
    noises (a noise dataclass such as ``RolloutNoise`` or
    ``VoliroNoise``, or one tensor); lanes that share one noise object
    share its memory (an expand)."""
    fields = [[getattr(n, f.name) for f in dataclasses.fields(n)]
              if dataclasses.is_dataclass(n) else [n] for n in noises]
    if all(n is noises[0] for n in noises):
        return [t.expand((len(noises),) + t.shape) for t in fields[0]]
    return [torch.stack(ts) for ts in zip(*fields)]


def noise_like(template, tensors):
    """One lane's noise from its :func:`stack_noise` fields, shaped as
    ``template``."""
    if dataclasses.is_dataclass(template):
        return type(template)(*tensors)
    return tensors[0]


class LaneAdam:
    """Adam over stacked ``[L, ...]`` leaves with a step count and a
    learning rate per lane (``lr``: [L]). The update is
    ``torch.optim.Adam``'s (betas 0.9, 0.999, eps 1e-8, optax's
    defaults) lane by lane. ``step(grads, ok)`` leaves the lanes where
    ``ok`` is False untouched: params, moments and count."""

    def __init__(self, leaves, lr):
        self.leaves = list(leaves)
        self.exp_avg = [torch.zeros_like(p) for p in self.leaves]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.leaves]
        # a copy: load() writes into it, and the caller's array must not change
        self.lr = torch.tensor(np.asarray(lr, dtype=np.float64), device=self.leaves[0].device)
        self.step_count = torch.zeros_like(self.lr)

    def state(self) -> dict:
        """The optimizer state: moments, step counts and learning rates."""
        return {"exp_avg": self.exp_avg, "exp_avg_sq": self.exp_avg_sq,
                "step": self.step_count, "lr": self.lr}

    def load(self, state: dict) -> None:
        """Copy ``state`` (as :meth:`state` gives it) into this one."""
        with torch.no_grad():
            for mine, saved in zip(self.exp_avg + self.exp_avg_sq,
                                   list(state["exp_avg"]) + list(state["exp_avg_sq"])):
                mine.copy_(saved)
            self.step_count.copy_(state["step"])
            self.lr.copy_(state["lr"])

    @torch.no_grad()
    def step(self, grads, ok=None) -> None:
        lanes = self.lr.shape[0]
        count = self.step_count + (1.0 if ok is None else ok.to(self.lr.dtype))
        bc1 = 1.0 - BETA1 ** count
        bc2_sqrt = torch.sqrt(1.0 - BETA2 ** count)
        step_size = self.lr / bc1
        for p, g, m, v in zip(self.leaves, grads, self.exp_avg, self.exp_avg_sq):
            shape = (lanes,) + (1,) * (p.dim() - 1)
            m_new = m.lerp(g, 1.0 - BETA1)
            v_new = torch.addcmul(v * BETA2, g, g, value=1.0 - BETA2)
            denom = torch.sqrt(v_new) / bc2_sqrt.to(p.dtype).view(shape) + EPS
            p_new = p - step_size.to(p.dtype).view(shape) * m_new / denom
            if ok is not None:
                keep = ~ok.view(shape)
                m_new = torch.where(keep, m, m_new)
                v_new = torch.where(keep, v, v_new)
                p_new = torch.where(keep, p, p_new)
            m.copy_(m_new)
            v.copy_(v_new)
            p.copy_(p_new)
        self.step_count.copy_(count)


def _lane_rows(a, i):
    return [t.detach()[i].clone() for t in a]


class MultiSeedTrainer:
    """Trains ``n_seeds`` independent replicates of ``model`` in one
    lane-batched program. The interface is the JAX trainer's: per-lane
    results in ``train_all`` / ``test_all`` (lists of [n_seeds] arrays),
    ``best_loss``, :meth:`best_seed`, :meth:`params_for` and
    :meth:`seed_view`.

    Two test seams, as in ``Trainer``: ``init_params`` (stacked params,
    e.g. a converted ``jax.vmap(model.init)``) replaces the lanes'
    inits, and ``noise_fn(epoch, split, i, lane, b, t_len) -> noise |
    None`` replaces a lane's draws.
    """

    def __init__(self, model, model_dir, n_seeds: int, seed: int = 0, mesh=None,
                 metrics_path=None, epochs_per_dispatch=None, init_params=None, noise_fn=None):
        if mesh is not None:
            raise ValueError("MultiSeedTrainer(mesh=...) is not ported (ROADMAP A6.1)")
        if epochs_per_dispatch not in (None, "auto"):
            raise ValueError(
                "MultiSeedTrainer(epochs_per_dispatch=...) (fused multi-epoch dispatch) is not "
                "ported (ROADMAP A4.1 follow-up); only 'auto' is accepted")
        self.model = model
        self.model_dir = model_dir
        self.device = model.device
        self.n_seeds = int(n_seeds)
        self.seed = seed
        self.params = None  # stacked [n_seeds, ...] params
        self.opt = None
        self.best_params = None
        self.best_opt = None
        self.best_loss = None  # [n_seeds]
        self.train_all = []  # [n_seeds] arrays, one an epoch
        self.test_all = []
        self._rng = np.random.default_rng(seed)
        self.metrics = MetricsLogger(metrics_path)
        self.saver = checkpoint.shared_saver()
        self._guard = bool(model.config.skip_nonfinite_updates)
        self.skipped_steps = 0  # cumulative skipped batches, all lanes
        self._init_params = init_params
        self._noise_fn = noise_fn
        # trailing leaves that are not trained (a sweep's hyperparameters)
        self._frozen = int(getattr(model, "frozen_leaves", 0))
        self._device_data = {}
        os.makedirs(model_dir, exist_ok=True)

    # --- state -----------------------------------------------------------

    def _stacked_init(self):
        """Stacked [n_seeds, ...] params (override hook)."""
        if self._init_params is not None:
            return self._init_params.to(device=self.device, dtype=self.model.dtype)
        lanes = [self.model.init(torch.Generator(device=self.device).manual_seed(
            init_seed(self.seed, lane))) for lane in range(self.n_seeds)]
        return lanes[0].with_tensors([torch.stack(ts) for ts in
                                      zip(*(p.tensors() for p in lanes))])

    def _learning_rates(self):
        """[n_seeds] learning rates (override hook)."""
        return np.full(self.n_seeds, float(self.model.config.learning_rate))

    def _trainable(self, params) -> list:
        leaves = params.tensors()
        return leaves[:len(leaves) - self._frozen]

    def _fresh_state(self):
        params = self._stacked_init()
        n_train = len(params.tensors()) - self._frozen
        leaves = [t.detach().clone().requires_grad_(k < n_train)
                  for k, t in enumerate(params.tensors())]
        self.params = params.with_tensors(leaves)
        self.opt = LaneAdam(self._trainable(self.params), self._learning_rates())

    def _load(self, name: str):
        tree = checkpoint.restore(os.path.join(self.model_dir, name), map_location=self.device)
        leaves = self.params.tensors()
        saved = tree["params"]
        if len(saved) != len(leaves) or any(s.shape != t.shape for s, t in zip(saved, leaves)):
            raise ValueError(
                f"{name} holds {len(saved)} stacked params of shapes "
                f"{[tuple(s.shape) for s in saved]}, this trainer "
                f"{[tuple(t.shape) for t in leaves]} ({self.n_seeds} lanes)")
        with torch.no_grad():
            for leaf, s in zip(leaves, saved):
                leaf.copy_(s)
        self.opt.load(tree["opt_state"])

    def _snapshot(self):
        """Copies of the stacked params and optimizer state."""
        return ([t.detach().clone() for t in self.params.tensors()],
                {k: v.clone() if torch.is_tensor(v) else [t.clone() for t in v]
                 for k, v in self.opt.state().items()})

    def init_state(self, retrain: bool = False):
        self._fresh_state()
        if retrain:
            self.saver.flush(self.model_dir)  # pending writes must land first
            self._load(LAST_SEEDS)
        self.best_params, self.best_opt = self._snapshot()
        self.best_loss = np.full(self.n_seeds, np.inf)

    # --- batches -------------------------------------------------------

    def _stage(self, tag, data_in, data_out):
        """The windowed dataset on the model's device, once per train()."""
        if tag not in self._device_data:
            kw = dict(dtype=self.model.dtype, device=self.device)
            self._device_data[tag] = (torch.as_tensor(np.asarray(data_in), **kw),
                                      torch.as_tensor(np.asarray(data_out), **kw))
        return self._device_data[tag]

    def _single_indices(self, n, batch_size, shuffle: bool):
        """One [n_batches, B] index/weight pair (Trainer semantics)."""
        return epoch_indices(self._rng, n, batch_size, shuffle, self.model.np_dtype)

    def _epoch_indices(self, n, batch_size, shuffle: bool):
        """Per-lane [n_seeds, n_batches, B] gather indices and weights
        (override hook)."""
        pairs = [self._single_indices(n, batch_size, shuffle) for _ in range(self.n_seeds)]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def _lane_noise(self, epoch, split, i, lane, b, t_len):
        """Lane ``lane``'s noise for one batch."""
        if self._noise_fn is not None:
            noise = self._noise_fn(epoch, split, i, lane, b, t_len)
            if noise is not None:
                return noise
        gen = torch.Generator(device=self.device)
        gen.manual_seed(lane_batch_seed(self.seed, epoch, split, lane, i))
        return self.model.draw_noise(gen, t_len, b)

    def _noises(self, epoch, split, i, b, t_len) -> list:
        """Every lane's noise for one batch (override hook)."""
        return [self._lane_noise(epoch, split, i, lane, b, t_len)
                for lane in range(self.n_seeds)]

    # --- the lane-batched program -----------------------------------------

    def lane_losses(self, params, u, y, weights, noises: list, lanes_data: bool = True):
        """[n_seeds] losses of the stacked ``params``, all lanes in one
        vmapped ``model.loss``: ``u``/``y``/``weights`` carry a leading
        lane axis when ``lanes_data`` (each lane's own shuffle), else one
        batch is shared by every lane; ``noises`` has one noise per lane."""
        template = noises[0]

        def one(leaves, u, y, w, nts):
            return self.model.loss(params.with_tensors(leaves), u, y, None, True, w,
                                   noise_like(template, nts))[0]

        d = 0 if lanes_data else None
        return vmap(one, in_dims=(0, d, d, d, 0))(params.tensors(), u, y, weights,
                                                   stack_noise(noises))

    def train_step(self, u, y, weights, noises: list):
        """One Adam step of every lane on its batch (``u``/``y``/``weights``
        with a leading lane axis). Returns ``(losses [n_seeds], applied
        [n_seeds] bool)``, the losses detached."""
        trainable = self._trainable(self.params)
        for p in trainable:
            p.grad = None
        losses = self.lane_losses(self.params, u, y, weights, noises)
        losses.sum().backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in trainable]
        ok = None
        if self._guard:
            ok = torch.isfinite(losses.detach())
            for g in grads:
                ok = ok & torch.isfinite(g).reshape(g.shape[0], -1).all(dim=1)
        self.opt.step(grads, ok)
        applied = torch.ones_like(losses, dtype=torch.bool) if ok is None else ok
        return losses.detach(), applied

    def _epoch_train(self, ds, batch_size, epoch):
        data_u, data_y = self._stage("train", ds.train_in_batch, ds.train_out_batch)
        idx, w = self._epoch_indices(data_u.shape[0], batch_size, shuffle=True)
        idx_d = torch.as_tensor(idx.astype(np.int64), device=self.device)
        w_d = torch.as_tensor(w, device=self.device)
        t_len = data_u.shape[1]
        losses, applied = [], []
        for i in range(idx.shape[1]):
            rows = idx_d[:, i]  # [n_seeds, B]
            loss, ok = self.train_step(data_u[rows], data_y[rows], w_d[:, i],
                                       self._noises(epoch, 0, i, batch_size, t_len))
            losses.append(loss)
            applied.append(ok)
        skipped = (~torch.stack(applied)).sum(dim=0).cpu().numpy()
        return torch.stack(losses).mean(dim=0).cpu().numpy().astype(np.float64), skipped

    @torch.no_grad()
    def _epoch_eval(self, ds, batch_size, epoch):
        data_u, data_y = self._stage("test", ds.test_in_batch, ds.test_out_batch)
        idx, w = self._single_indices(data_u.shape[0], batch_size, shuffle=False)
        idx_d = torch.as_tensor(idx.astype(np.int64), device=self.device)
        w_d = torch.as_tensor(w, device=self.device)
        t_len = data_u.shape[1]
        losses = [
            self.lane_losses(self.params, data_u[idx_d[i]], data_y[idx_d[i]], w_d[i],
                             self._noises(epoch, 1, i, batch_size, t_len), lanes_data=False)
            for i in range(idx.shape[0])
        ]
        return torch.stack(losses).mean(dim=0).cpu().numpy().astype(np.float64)

    # --- main loop -------------------------------------------------------------

    def train(self, ds, epochs: int, retrain: bool = False):
        print(f"\nTraining {self.n_seeds} seeds (vmapped)...\n")
        self.init_state(retrain)
        self._device_data = {}
        batch_size = int(self.model.config.batch_size)
        for epoch in range(epochs):
            t0 = time.perf_counter()
            train_np, skipped = self._epoch_train(ds, batch_size, epoch)
            test_np = self._epoch_eval(ds, batch_size, epoch)
            if self._guard:
                self._note_skipped(skipped)
            improved = train_np < self.best_loss
            if improved.any():
                self._update_best(improved, train_np)
            self._log_epoch(epoch, train_np, test_np, time.perf_counter() - t0,
                            skipped if self._guard else None)
            if improved.any():
                # best saved on every improvement, as Trainer does
                self._save_best()
        self.saver.save(os.path.join(self.model_dir, LAST_SEEDS),
                        {"params": [t.detach() for t in self.params.tensors()],
                         "opt_state": self.opt.state()})
        self.saver.save(os.path.join(self.model_dir, checkpoint.LAST),
                        self._single_tree(self.best_seed(), best=False))
        self.saver.flush(self.model_dir)
        self.metrics.log(event="done", epochs=epochs, best_train=self.best_loss.tolist(),
                         **({"skipped_steps": self.skipped_steps} if self._guard else {}))

    def _update_best(self, improved, train_np):
        """Take the improved lanes' params, optimizer state and loss into
        the best state."""
        params, opt = self._snapshot()
        mask = torch.as_tensor(improved, device=self.device)

        def sel(best, new):
            return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, best)

        self.best_params = [sel(b, n) for b, n in zip(self.best_params, params)]
        self.best_opt = {k: sel(self.best_opt[k], v) if torch.is_tensor(v)
                         else [sel(b, n) for b, n in zip(self.best_opt[k], v)]
                         for k, v in opt.items()}
        self.best_loss = np.where(improved, train_np, self.best_loss)

    def _note_skipped(self, skipped):
        total = int(skipped.sum())
        if total:
            self.skipped_steps += total
            print(f"  [guard] skipped {total} non-finite batch update(s) across lanes",
                  file=sys.stderr)

    def _log_epoch(self, epoch, train_np, test_np, dt, skipped=None):
        print(f"[{epoch:04}]: Train {train_np.mean():.4f} "
              f"(per-seed {np.array2string(train_np, precision=2)}), "
              f"Test {test_np.mean():.4f}  ({dt:.2f}s)")
        self.train_all.append(train_np)
        self.test_all.append(test_np)
        extra = {"skipped_steps": skipped.tolist()} if skipped is not None else {}
        self.metrics.log(event="epoch", epoch=epoch, train_loss=train_np.tolist(),
                         test_loss=test_np.tolist(), seconds=dt, **extra)

    def _save_best(self):
        self.saver.save(os.path.join(self.model_dir, BEST_SEEDS),
                        {"params": self.best_params, "opt_state": self.best_opt})
        self.saver.save(os.path.join(self.model_dir, checkpoint.BEST),
                        self._single_tree(self.best_seed(), best=True))

    def _single_tree(self, i: int, best: bool) -> dict:
        """The tree of best.ckpt / model.ckpt: lane ``i``'s unstacked
        trained leaves and its Adam state, in ``Trainer``'s format."""
        leaves = self.best_params if best else self.params.tensors()
        opt = self.best_opt if best else self.opt.state()
        n_train = len(leaves) - self._frozen
        params = _lane_rows(leaves[:n_train], i)
        adam = torch.optim.Adam(params, lr=float(opt["lr"][i]), betas=(BETA1, BETA2), eps=EPS)
        for p, m, v in zip(params, opt["exp_avg"], opt["exp_avg_sq"]):
            adam.state[p] = {"step": torch.tensor(float(opt["step"][i])),
                             "exp_avg": m.detach()[i].clone(),
                             "exp_avg_sq": v.detach()[i].clone()}
        return {"params": params, "opt_state": adam.state_dict()}

    # --- results ---------------------------------------------------------

    def lane_predict(self, params, u, y, noise, condition: bool = False):
        """``(pred_mean, pred_var)`` of every lane of the stacked
        ``params`` on one shared batch and noise, in one vmapped
        ``model.predict`` under inference mode: [n_seeds, B, T, dy]."""

        def one(leaves):
            out = self.model.predict(params.with_tensors(leaves), u, y, None, condition, noise)
            return out.pred_mean, out.pred_var

        with torch.inference_mode():
            return vmap(one)(params.tensors())

    def _test_predictions(self, ds, seed, best, condition):
        """Per test experiment: denormalized (mean, std) [n_seeds, T, dy]
        of every lane and the ground truth, with ``Outputs``' noise (a
        generator seeded ``seed``, the same for every lane)."""
        params = self.params.with_tensors(
            self.best_params if best else [t.detach() for t in self.params.tensors()])
        kw = dict(dtype=self.model.dtype, device=self.device)
        for i in range(ds.test_in.shape[0]):
            u = torch.as_tensor(np.asarray(ds.test_in[i:i + 1]), **kw)
            y = torch.as_tensor(np.asarray(ds.test_out[i:i + 1]), **kw)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = self.model.draw_noise(gen, u.shape[1], 1)
            mean, var = self.lane_predict(params, u, y, noise, condition)
            mean = ds.denormalize(mean.cpu().numpy(), "out")[:, 0]
            std = ds.denormalize(np.sqrt(var.cpu().numpy()), "out", shift=False)[:, 0]
            gt = ds.denormalize(np.asarray(ds.test_out[i:i + 1]), "out")[0]
            yield mean, std, gt

    def evaluate_rmse(self, ds, seed: int = 0, best: bool = True,
                      condition: bool = False) -> np.ndarray:
        """Free-running test RMSE of every lane ([n_seeds]), all lanes in
        one vmapped predict per test experiment. The semantics of
        ``Outputs.test_mse`` (per-experiment MSE of the denormalized
        particle mean, averaged, then the root), with its noise: a
        generator seeded ``seed`` (``Outputs``' default 0)."""
        mse = np.zeros(self.n_seeds)
        n_exp = 0
        for mean, _, gt in self._test_predictions(ds, seed, best, condition):
            mse += np.mean((mean - gt) ** 2, axis=(1, 2))
            n_exp += 1
        return np.sqrt(mse / n_exp)

    def evaluate_calibration(self, ds, seed: int = 0, best: bool = True,
                             condition: bool = False, levels=None):
        """Per-lane predictive NLL, interval coverage, ECE and
        standardized-error RMS (``Outputs.calibration``'s semantics), from
        the vmapped predicts of :meth:`evaluate_rmse`: a list of
        ``n_seeds`` stats dicts."""
        from cbfssm_tpu_torch.outputs import calibration as cal

        levels = cal.LEVELS if levels is None else levels
        parts = [[] for _ in range(self.n_seeds)]
        for mean, std, gt in self._test_predictions(ds, seed, best, condition):
            for s in range(self.n_seeds):
                parts[s].append(cal.summarize(mean[s], np.square(std[s]), gt, levels))
        return [cal.accumulate(p) for p in parts]

    def best_seed(self) -> int:
        return int(np.argmin(self.best_loss))

    def params_for(self, i: int, best: bool = True):
        """Lane ``i``'s unstacked params (detached copies)."""
        leaves = self.best_params if best else self.params.tensors()
        return self.params.with_tensors(_lane_rows(leaves, i))

    def seed_view(self, i: int) -> "SeedView":
        """A ``Trainer``-shaped view of lane ``i`` for the outputs."""
        return SeedView(self, i)


class SeedView:
    """One lane of a :class:`MultiSeedTrainer` through the interface the
    outputs read of a ``Trainer``: ``train_all`` / ``test_all``,
    ``params`` and ``restore(name)``."""

    def __init__(self, ms: MultiSeedTrainer, i: int):
        if not 0 <= i < ms.n_seeds:
            raise IndexError(f"seed {i} out of range (n_seeds={ms.n_seeds})")
        self._ms = ms
        self._i = i
        self.train_all = [float(losses[i]) for losses in ms.train_all]
        self.test_all = [float(losses[i]) for losses in ms.test_all]

    @property
    def params(self):
        return self._ms.params_for(self._i, best=False)

    def restore(self, name: str = checkpoint.BEST):
        return self._ms.params_for(self._i, best=(name == checkpoint.BEST))
