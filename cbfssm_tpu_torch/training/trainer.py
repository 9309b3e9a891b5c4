"""Training loop (port of ``cbfssm_tpu/training/trainer.py``).

Per epoch: a shuffled pass over the window batches with one Adam step
per batch (the loss is a weighted sum within a batch; the ragged last
batch is padded with index 0 at weight 0), then the test-set loss with
``condition=True``, one stdout line, ``metrics.jsonl`` events, a best
checkpoint whenever the train loss improves and the last checkpoint at
the end; ``retrain=True`` resumes from the last checkpoint.

Fused multi-epoch dispatch (``epochs_per_dispatch``, resolved as the
JAX package resolves it: 'auto' is ~300 optimizer steps a dispatch). The
JAX package runs a block of k epochs as one device program. Here a block
is k epochs whose host issues every step and every evaluation without a
host sync: the losses, the guard's skip decision, the running best train
loss and the best params and optimizer state stay on the device (the
best copied under ``torch.where`` of that comparison). The host issues
block k+1 before it reads block k back (a one-deep pipeline, JAX's
``_dispatch_block`` / ``_process_block``): block k's losses and best
state are copied to pinned host memory behind its last kernel, and the
host waits on that copy's event alone, so the card runs block k+1 while
the host logs block k and saves its best checkpoint. Fewer than k epochs
left run epoch by epoch. Both schedules issue the same operations in the
same order, so their losses and checkpoints are bitwise equal.
The model directory describes itself: ``__init__`` writes
``model_meta.json`` (:func:`~cbfssm_tpu_torch.model_store.save_model_meta`)
and ``train`` stamps the dataset's recipe into it
(:func:`~cbfssm_tpu_torch.model_store.record_dataset`), so
``python -m cbfssm_tpu_torch eval | serve <dir>`` rebuilds the model
without the script that trained it. ``profile_dir`` traces the
training half of epoch 1 under :func:`~cbfssm_tpu_torch.utils.profiling.trace`
(a run of one epoch writes no trace).

On a CUDA device (no mesh, no ``ParticleParallel`` model) the train step
and the test batch run as replays of CUDA graphs
(:mod:`~cbfssm_tpu_torch.training.step_graph`), with the eager path's
numbers; :meth:`Trainer.graph_counts` says how often.

Both schedules mark their layers with
:func:`~cbfssm_tpu_torch.utils.profiling.span` (:data:`SPAN_PHASES`
names each span's phase): nothing while no caller records spans, and
neither a kernel nor a read-back when one does. One ``step`` span a
train step, one ``eval.loss`` span a test batch.

``mesh`` (a ``DeviceMesh`` from :mod:`cbfssm_tpu_torch.parallel`) trains
across a process group, one process per GPU: the batch size is rounded
up to the data axis, every rank draws the same shuffle and the whole
batch's noise and takes its row block of both, backpropagates its share
of the loss (the global term counted once, ``parallel.mesh_loss``), and
the gradient is summed over the mesh in one ``all_reduce``, so Adam
steps on the same numbers everywhere. The losses are the unmeshed ones
up to summation order. A ``ParticleParallel`` model shards its
particles (and, with a data axis, its rows) itself. Rank 0 alone
writes the directory's files and prints; every rank loads them.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from cbfssm_tpu_torch import model_store
from cbfssm_tpu_torch.config import check_epochs_per_dispatch
from cbfssm_tpu_torch.parallel import DataParallel, ParticleParallel, noise_rows
from cbfssm_tpu_torch.parallel.sharding import check_mesh
from cbfssm_tpu_torch.training import checkpoint, step_graph
from cbfssm_tpu_torch.training.step_graph import FALLBACK, StaticBatch, StepGraph
from cbfssm_tpu_torch.utils import profiling
from cbfssm_tpu_torch.utils.profiling import MetricsLogger, span, trace
from cbfssm_tpu_torch.utils.transfer import host_copy, ready_event, upload

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults

# the Trainer's spans by the phase of training they time; the parents
# (trainer.train, trainer.epoch, step) count their own time, outside
# their children, as bookkeeping
SPAN_PHASES = {
    "data.epoch": "data",  # an epoch's shuffle and its index and weight uploads
    "data.batch": "data",  # a batch's gathers, weights and draws (generator or noise_fn)
    "step.forward": "forward",  # the loss
    "step.backward": "backward",  # autograd, zero-filled leaves, the mesh's reduce
    "step.optimizer": "optimizer",  # zero_grad; the guard and the Adam step
    "eval.loss": "eval",  # a test batch's loss
    "step.capture": "capture",  # a graph's capture (the step's spans inside it)
    "step.replay": "replay",  # a graph's launch: a train step's or a test batch's work
    "trainer.readback": "bookkeeping",  # host reads of device values, a block's wait
    "trainer.block": "bookkeeping",  # a block's best state on the device and its copies
    "trainer.checkpoint": "bookkeeping",
    "trainer.log": "bookkeeping",
    "trainer.train": "bookkeeping",
    "trainer.epoch": "bookkeeping",
    "step": "bookkeeping",
}


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


def resolve_epochs_per_dispatch(epd, steps_per_epoch: int, epochs: int) -> int:
    """'auto' -> ~300 optimizer steps per dispatch, clamped to [1, 64]
    and to the run's epoch count (shared by Trainer and
    MultiSeedTrainer)."""
    if epd == "auto":
        epd = max(1, min(64, round(300 / max(1, steps_per_epoch))))
    return max(1, min(int(epd), max(1, epochs)))


def adam_leaf(p, g, m, v, step_size, bc2_sqrt, keep=None) -> None:
    """One Adam update of leaf ``p`` (moments ``m``, ``v``) in place:
    ``torch.optim.Adam``'s formula (not its rounding: it divides the
    scaled moment, not the moment) with betas 0.9, 0.999 and eps 1e-8
    (optax's defaults), ``step_size`` = lr / (1 - beta1^t) and
    ``bc2_sqrt`` = sqrt(1 - beta2^t) broadcastable to ``p`` in its dtype.
    Where ``keep`` is True, p, m and v keep their values."""
    m_new = m.lerp(g, 1.0 - BETA1)
    v_new = torch.addcmul(v * BETA2, g, g, value=1.0 - BETA2)
    denom = torch.sqrt(v_new) / bc2_sqrt + EPS
    p_new = p - step_size * m_new / denom
    if keep is not None:
        m_new = torch.where(keep, m, m_new)
        v_new = torch.where(keep, v, v_new)
        p_new = torch.where(keep, p, p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)


@torch.no_grad()
def adam_update(leaves, grads, states, lr: float, ok=None) -> None:
    """One Adam step of every leaf (:func:`adam_leaf`) with the step count
    on the device, so that nothing is read back. ``states`` holds one
    dict a leaf in ``torch.optim.Adam``'s format (``step``, ``exp_avg``,
    ``exp_avg_sq``), filled at the first step. With ``ok`` (a 0-d bool)
    the step is applied only where it holds, the JAX
    ``apply_update_guarded``'s ``where(ok, new, old)``. The count and the
    bias corrections are computed once for all leaves."""
    for p, state in zip(leaves, states):
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    count = states[0]["step"] + (1.0 if ok is None else ok.to(torch.float32))
    t = count.to(torch.float64)
    step_size = lr / (1.0 - BETA1 ** t)
    bc2_sqrt = torch.sqrt(1.0 - BETA2 ** t)
    keep = None if ok is None else ~ok
    scalars = {}  # per dtype
    for p, g, state in zip(leaves, grads, states):
        if p.dtype not in scalars:
            scalars[p.dtype] = (step_size.to(p.dtype), bc2_sqrt.to(p.dtype))
        adam_leaf(p, g, state["exp_avg"], state["exp_avg_sq"], *scalars[p.dtype], keep)
        state["step"].copy_(count)


def batch_seed(seed: int, epoch: int, split: int, i: int) -> int:
    """The seed of batch ``i`` of ``split`` (0 train, 1 test) in
    ``epoch``: a function of the four numbers alone, as the JAX trainer's
    ``fold_in(fold_in(fold_in(PRNGKey(seed + 1), epoch), split), i)``
    key is (the numbers drawn differ: Philox, not threefry)."""
    entropy = [seed + 1, epoch, split, i]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def stamp_model_meta(model_dir, model, seed) -> None:
    """``model_store.save_model_meta``, best-effort: a model the snapshot
    cannot describe must never break training (the directory then only
    cannot be reopened by ``eval`` / ``serve``)."""
    try:
        model_store.save_model_meta(model_dir, model, seed=seed)
    except Exception as exc:
        print(f"model_meta snapshot failed ({exc}); {model_dir} will not be reloadable",
              file=sys.stderr)


def stamp_dataset(model_dir, ds) -> None:
    """``model_store.record_dataset``, best-effort: a directory without a
    snapshot, or an unusual dataset, must not break training."""
    try:
        model_store.record_dataset(model_dir, ds)
    except Exception:
        pass


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
    CBFSSM, a ``[T-1, B, S, 1]`` tensor for the others; on a mesh the
    whole batch's, of which each rank takes its rows; for a
    ``ParticleParallel`` model this rank's shard's).
    ``epochs_per_dispatch`` (None: the config's) sets the epochs of a
    block (:func:`resolve_epochs_per_dispatch`; 1 under ``profile_dir``).
    """

    def __init__(self, model, model_dir, mesh=None, seed=0, metrics_path=None,
                 profile_dir=None, init_params=None, noise_fn=None, epochs_per_dispatch=None):
        check_mesh(mesh, "Trainer")
        self._particle = isinstance(model, ParticleParallel)
        if self._particle:
            if mesh is not None and mesh is not model.mesh:
                raise ValueError("Trainer(mesh=) must be the ParticleParallel model's mesh")
            mesh = model.mesh
        self.dp = DataParallel(mesh)
        self.model = model
        self.profile_dir = profile_dir
        self.model_dir = model_dir
        self.device = model.device
        self.seed = seed
        self.epochs_per_dispatch = (model.config.epochs_per_dispatch
                                    if epochs_per_dispatch is None else epochs_per_dispatch)
        check_epochs_per_dispatch(self.epochs_per_dispatch)
        self.train_all = []
        self.test_all = []
        self.params = None
        self.optimizer = None
        self._rng = np.random.default_rng(seed)
        self.metrics = MetricsLogger(metrics_path if self.dp.writer else None)
        self.saver = checkpoint.shared_saver()
        self._guard = bool(model.config.skip_nonfinite_updates)
        self.skipped_steps = 0  # cumulative non-finite batches skipped
        self._last_skipped = 0
        self._init_params = init_params
        self._noise_fn = noise_fn
        self._device_data = {}
        self._best_dev = None  # the device-side running best of a blocked train()
        # CUDA graphs of the train step and test batch (step_graph)
        self._graph_on = step_graph.eligible(self.device, self.dp.mesh, self._particle)
        self._graphs = {}  # key -> StepGraph, or FALLBACK
        self._static = {}  # split -> the StaticBatch of its newest graph
        self._graph_pool = self._graph_stream = None
        self._warm_shapes = set()  # (split, shapes) run eagerly
        self.graph_captures = self.graph_replays = self.eager_steps = self.graph_fallbacks = 0
        os.makedirs(model_dir, exist_ok=True)
        if self.dp.writer:
            stamp_model_meta(model_dir, model, seed)

    # --- state -----------------------------------------------------------

    def _fresh_state(self):
        """Init params in leaves that require grad, and a new Adam with
        optax's ``adam`` defaults (a ``torch.optim.Adam`` that holds the
        state in its format and is stepped by :meth:`_adam_update`) at
        step 0 with zero moments, the state its first step would make.
        The leaves and the state's tensors are made at the first call and
        written in place after it, so that they live as long as the
        Trainer (its CUDA graphs read and write them)."""
        if self._init_params is not None:
            params = self._init_params.to(device=self.device, dtype=self.model.dtype)
        else:
            params = self.model.init(torch.Generator(device=self.device).manual_seed(self.seed))
        if self.params is None:
            self.params = params.with_tensors(
                [t.detach().clone().requires_grad_(True) for t in params.tensors()])
            states = [{"step": torch.zeros((), dtype=torch.float32, device=p.device),
                       "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
                      for p in self.params.tensors()]
        else:
            states = [self.optimizer.state[p] for p in self.params.tensors()]
            with torch.no_grad():
                for leaf, t in zip(self.params.tensors(), params.tensors(), strict=True):
                    leaf.copy_(t)
                for state in states:
                    for t in state.values():
                        t.zero_()
        leaves = self.params.tensors()
        self.optimizer = torch.optim.Adam(
            leaves, lr=float(self.model.config.learning_rate), betas=(BETA1, BETA2), eps=EPS
        )
        for p, state in zip(leaves, states):
            self.optimizer.state[p] = state

    def _load(self, name: str):
        """The checkpoint's params and Adam state (its hyperparameters
        too), written into the Trainer's own tensors."""
        tree = checkpoint.restore(os.path.join(self.model_dir, name), map_location=self.device)
        leaves = self.params.tensors()
        if len(tree["params"]) != len(leaves):
            raise ValueError(f"{name} holds {len(tree['params'])} params, the model {len(leaves)}")
        states = [self.optimizer.state[p] for p in leaves]
        self.optimizer.load_state_dict(tree["opt_state"])
        with torch.no_grad():
            for leaf, saved, state in zip(leaves, tree["params"], states):
                leaf.copy_(saved)
                loaded = self.optimizer.state[leaf]  # none before a leaf's first step
                for key, t in state.items():
                    if key in loaded:
                        t.copy_(loaded[key])
                    else:
                        t.zero_()
                self.optimizer.state[leaf] = state

    def init_state(self, retrain: bool = False):
        self._fresh_state()
        if retrain:
            self.saver.flush(self.model_dir)  # pending writes must land first
            self._load(checkpoint.LAST)

    def restore(self, name: str = checkpoint.BEST):
        """Load a checkpoint into the trainer's state; returns its params,
        whose leaves a later ``train()`` or ``restore()`` overwrites."""
        self.saver.flush(self.model_dir)  # pending writes must land first
        self._fresh_state()
        self._load(name)
        return self.params

    def _save(self, name: str, tree=None):
        """Save ``tree`` (default: the live params and optimizer state)."""
        if not self.dp.writer:
            return
        with span("trainer.checkpoint"):
            if tree is None:
                tree = {"params": [t.detach() for t in self.params.tensors()],
                        "opt_state": self.optimizer.state_dict()}
            self.saver.save(os.path.join(self.model_dir, name), tree)

    # --- batching ----------------------------------------------------------

    def _stage(self, tag, data_in, data_out):
        """The windowed dataset on the model's device, once per train()."""
        if tag not in self._device_data:  # uploaded without a host sync
            self._device_data[tag] = (upload(data_in, self.device, self.model.dtype),
                                      upload(data_out, self.device, self.model.dtype))
        return self._device_data[tag]

    def _epoch_indices(self, n, batch_size, shuffle: bool):
        return epoch_indices(self._rng, n, batch_size, shuffle, self.model.np_dtype)

    def _batches(self, data_u, data_y, batch_size, shuffle, epoch, split):
        """(u, y, weights, generator, noise) of each batch of an epoch."""
        with span("data.epoch"):
            idx, w = self._epoch_indices(data_u.shape[0], batch_size, shuffle)
            idx_d = upload(idx.astype(np.int64), self.device)
            w_d = upload(w, self.device)
        t_len = data_u.shape[1]
        static = self._static.get(split)  # the split's graph inputs, gathered into
        if static is not None and (static.u.shape, static.y.shape) != (
                (batch_size,) + data_u.shape[1:], (batch_size,) + data_y.shape[1:]):
            static = None
        for i in range(idx.shape[0]):
            with span("data.batch"):
                noise = None
                if self._noise_fn is not None:
                    noise = self._noise_fn(epoch, split, i, batch_size, t_len)
                gen = None
                if noise is None:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(batch_seed(self.seed, epoch, split, i))
                if static is None:
                    u, y = data_u[idx_d[i]], data_y[idx_d[i]]
                else:
                    u = torch.index_select(data_u, 0, idx_d[i], out=static.u)
                    y = torch.index_select(data_y, 0, idx_d[i], out=static.y)
                batch = u, y, w_d[i], gen, noise
            yield batch  # outside the span: the caller's step is not data

    def _loss(self, u, y, weights, generator, noise):
        """The batch's ``(loss, aux)``. On a mesh (a plain model) this
        rank's rows of the batch and of its draws, combined over the mesh
        by ``DataParallel.loss``: the value is the batch's loss, the
        gradient this rank's share."""
        if self.dp.mesh is None or self._particle:
            return self.model.loss(self.params, u, y, generator, True, weights, noise)
        if noise is None:
            noise = self.model.draw_noise(generator, u.shape[1], u.shape[0])
        rows = self.dp.rows(u.shape[0])
        _, aux = self.model.loss(self.params, u[rows], y[rows], None, True, weights[rows],
                                 noise_rows(noise, rows))
        return self.dp.loss(aux, getattr(type(self.model), "REPLICATED_AUX", frozenset()))

    def train_step(self, u, y, weights, generator=None, noise=None):
        """One Adam step on one batch; returns ``(loss, applied)``, a
        detached 0-d loss and a 0-d bool, both on the device (nothing is
        read back). With ``skip_nonfinite_updates`` a batch whose loss or
        any gradient is not finite leaves params and optimizer state
        (moments and step count) unchanged, decided on the device
        (:meth:`_adam_update`); on a mesh every rank decides on the
        reduced flag, so all skip together."""
        with span("step"), self._own_stream():
            return self._graphed(0, self._step, u, y, weights, generator, noise)

    def _step(self, u, y, weights, generator, noise):
        """The work of :meth:`train_step`, run eagerly or captured."""
        with span("step.optimizer"):
            self.optimizer.zero_grad(set_to_none=True)
        with span("step.forward"):
            loss, _ = self._loss(u, y, weights, generator, noise)
        with span("step.backward"):
            loss.backward()
            leaves = self.params.tensors()
            for p in leaves:
                if p.grad is None:  # a leaf the loss does not reach: zero, as in JAX
                    p.grad = torch.zeros_like(p)
            self.dp.reduce_grads([p.grad for p in leaves])
        with span("step.optimizer"):
            ok = None
            if self._guard:
                ok = torch.isfinite(loss)
                for p in leaves:
                    ok = ok & torch.isfinite(p.grad).all()
                ok = self.dp.all_reduce_scalars(ok.to(loss.dtype),
                                                op=torch.distributed.ReduceOp.MIN) > 0.5
            self._adam_update(leaves, ok)
            applied = (torch.ones((), dtype=torch.bool, device=loss.device) if ok is None
                       else ok)
        return loss.detach(), applied

    def _eval_loss(self, u, y, weights, generator, noise):
        return (self._loss(u, y, weights, generator, noise)[0],)

    # --- CUDA graphs (step_graph) -------------------------------------------

    def graph_counts(self) -> dict:
        """How the train steps and test batches ran: ``graph_captures``,
        ``graph_replays`` (a captured step runs by a replay too),
        ``eager_steps`` and ``graph_fallbacks`` (captures that failed),
        over the Trainer's life."""
        return {"graph_captures": self.graph_captures, "graph_replays": self.graph_replays,
                "eager_steps": self.eager_steps, "graph_fallbacks": self.graph_fallbacks}

    @contextlib.contextmanager
    def _own_stream(self):
        """Run the block on the Trainer's own CUDA stream (a graphed
        Trainer's), after the caller's work and before its next: eager
        steps, captures and replays then share the stream's cuBLAS
        workspaces, which a capture on another stream would allocate
        anew."""
        if not self._graph_on:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        if caller == self._graph_stream:
            yield
            return
        self._graph_stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self._graph_stream):
                yield
        finally:
            caller.wait_stream(self._graph_stream)

    def _graphed(self, split, body, u, y, w, generator, noise):
        """``body(u, y, w, generator, noise)``, a tuple of tensors: run as
        a replay of the key's CUDA graph, captured here once the key may
        be (:mod:`~cbfssm_tpu_torch.training.step_graph`), or eagerly.
        A replay returns fresh tensors."""
        if not self._graph_on:
            self.eager_steps += 1
            return body(u, y, w, generator, noise)
        shapes = (split,) + tuple((tuple(t.shape), t.dtype) for t in (u, y, w))
        key = shapes + (self.optimizer.param_groups[0]["lr"],)
        entry = self._graphs.get(key)
        if isinstance(entry, StepGraph):
            with span("data.batch"):
                entry.batch.stage(self.model, u, y, w, generator, noise)
            with span("step.replay"):
                out = entry.replay()
            self.graph_replays += 1
            return out
        if entry is FALLBACK or shapes not in self._warm_shapes:
            self.eager_steps += 1
            out = body(u, y, w, generator, noise)
            self._warm_shapes.add(shapes)
            return out
        with span("data.batch"):
            batch = StaticBatch(self.model, u, y, w)
            batch.stage(self.model, u, y, w, generator, noise)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        try:
            with span("step.capture"):
                graph = StepGraph(body, batch, self._graph_pool, self._graph_stream)
        except Exception as exc:  # noqa: BLE001 - any failure leaves the key eager
            self._graphs[key] = FALLBACK
            self.graph_fallbacks += 1
            what = "train step" if split == 0 else "test batch"
            print(f"CUDA graph capture of the {what} failed, it runs eagerly from now on: "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr)
            self.eager_steps += 1
            return body(batch.u, batch.y, batch.w, None, batch.noise)
        self._graphs[key], self._static[split] = graph, batch
        self.graph_captures += 1
        with span("step.replay"):
            out = graph.replay()
        self.graph_replays += 1
        return out

    def _adam_update(self, leaves, ok=None) -> None:
        """One Adam step (:func:`adam_update`) on the leaves' ``.grad``,
        with ``ok`` the guard's 0-d bool. The state lives in
        ``self.optimizer.state`` in ``torch.optim.Adam``'s format, so
        checkpoints and ``load_state_dict`` are unchanged."""
        adam_update(leaves, [p.grad for p in leaves], [self.optimizer.state[p] for p in leaves],
                    self.optimizer.param_groups[0]["lr"], ok)

    def _train_epoch(self, ds, batch_size, epoch):
        """Issue one training epoch; returns its mean loss and (with the
        guard) its skipped-batch count as device tensors."""
        data_u, data_y = self._stage("train", ds.train_in_batch, ds.train_out_batch)
        if self._graphs and self._noise_fn is not None and profiling.recording():
            # a caller may stop its profiler at an epoch's start (in the
            # noise_fn of its first batch): let it hold the replays' records
            profiling.settle()
        losses, applied = [], []
        for u, y, w, gen, noise in self._batches(data_u, data_y, batch_size, True, epoch, 0):
            loss, ok = self.train_step(u, y, w, gen, noise)
            losses.append(loss)
            applied.append(ok)
        skipped = (~torch.stack(applied)).sum() if self._guard else None
        return torch.stack(losses).mean(), skipped

    @torch.no_grad()
    def _eval_epoch(self, ds, batch_size, epoch):
        """Issue one test-set evaluation; returns its mean loss on the
        device."""
        data_u, data_y = self._stage("test", ds.test_in_batch, ds.test_out_batch)
        losses = []
        for u, y, w, gen, noise in self._batches(data_u, data_y, batch_size, False, epoch, 1):
            with span("eval.loss"):
                losses.append(self._graphed(1, self._eval_loss, u, y, w, gen, noise)[0])
        return torch.stack(losses).mean()

    def _epoch_train(self, ds, batch_size, epoch):
        loss, skipped = self._train_epoch(ds, batch_size, epoch)
        with span("trainer.readback"):
            if self._guard:
                self._note_skipped(int(skipped))
            return float(loss)

    def _epoch_eval(self, ds, batch_size, epoch):
        loss = self._eval_epoch(ds, batch_size, epoch)
        with span("trainer.readback"):
            return float(loss)

    def _note_skipped(self, skipped: int):
        self._last_skipped = skipped
        self.skipped_steps += skipped
        if skipped and self.dp.writer:
            print(f"  [guard] skipped {skipped} non-finite batch update(s) this epoch",
                  file=sys.stderr)

    # --- main loop -----------------------------------------------------------

    def _resolve_epd(self, steps_per_epoch: int, epochs: int) -> int:
        """Epochs per block; 1 under ``profile_dir``, so that the traced
        epoch is a single epoch's work."""
        if self.profile_dir:
            return 1
        return resolve_epochs_per_dispatch(self.epochs_per_dispatch, steps_per_epoch, epochs)

    def _log_epoch(self, epoch, train_loss, test_loss, dt, steps_per_epoch):
        with span("trainer.log"):
            if self.dp.writer:
                print("[{epoch:04}]: Train {train}, Test {test}  ({dt:.2f}s)".format(
                    epoch=epoch, train=train_loss, test=test_loss, dt=dt))
            self.train_all.append(train_loss)
            self.test_all.append(test_loss)
            extra = {"skipped_steps": self._last_skipped} if self._guard else {}
            self.metrics.log(
                event="epoch", epoch=epoch, train_loss=train_loss, test_loss=test_loss,
                seconds=dt, steps_per_sec=steps_per_epoch / dt, **extra,
            )

    def train(self, ds, epochs: int, retrain: bool = False):
        with span("trainer.train"), self._own_stream():
            if self.dp.writer:
                print("\nTraining...\n")
                stamp_dataset(self.model_dir, ds)
            self.init_state(retrain)
            self._device_data = {}
            batch_size = self.dp.round_up_batch(int(self.model.config.batch_size))
            steps_per_epoch = -(-ds.train_in_batch.shape[0] // batch_size)
            epd = self._resolve_epd(steps_per_epoch, epochs)
            lowest_train = float("inf")
            self._best_dev = None
            pending = None  # the issued block the host has not read back yet
            epoch = 0
            while epoch < epochs:
                if epd > 1 and epochs - epoch >= epd:
                    # one-deep pipeline: issue block k+1, then read block k
                    handles = self._dispatch_block(ds, batch_size, epoch, epd, lowest_train)
                    if pending is not None:
                        lowest_train = self._process_block(pending, lowest_train, steps_per_epoch,
                                                           t_next=handles[2])
                    pending = handles
                    epoch += epd
                    continue
                if pending is not None:
                    # the per-epoch tail compares on the host: drain first
                    lowest_train = self._process_block(pending, lowest_train, steps_per_epoch)
                    pending = None
                with span("trainer.epoch"):
                    t0 = time.perf_counter()
                    if self.profile_dir and epoch == 1:
                        # epoch 1: past the first-call costs, a steady-state trace
                        with trace(self.profile_dir):
                            train_loss = self._epoch_train(ds, batch_size, epoch)
                    else:
                        train_loss = self._epoch_train(ds, batch_size, epoch)
                    test_loss = self._epoch_eval(ds, batch_size, epoch)
                    self._log_epoch(epoch, train_loss, test_loss, time.perf_counter() - t0,
                                    steps_per_epoch)
                    if train_loss < lowest_train:
                        self._save(checkpoint.BEST)
                        lowest_train = train_loss
                epoch += 1
            if pending is not None:
                lowest_train = self._process_block(pending, lowest_train, steps_per_epoch)
            self._save(checkpoint.LAST)
            with span("trainer.checkpoint"):
                self.saver.flush(self.model_dir)
            self.dp.barrier()  # rank 0's files are on disk before any rank reads them
            done_extra = {"skipped_steps": self.skipped_steps} if self._guard else {}
            self.metrics.log(event="done", epochs=epochs, best_train=lowest_train, **done_extra,
                             **self.graph_counts())

    def _dispatch_block(self, ds, batch_size, start: int, k: int, lowest_train: float):
        """Issue epochs [start, start + k) and return the block's handles
        without a host sync: the epochs are issued exactly as the
        per-epoch schedule issues them (the same shuffles, draws and
        steps), and after each the running best train loss, params and
        optimizer state are updated on the device under ``torch.where``
        (the first block starts from ``lowest_train``). The block's
        losses and best state are then copied to the host behind its
        last kernel, with an event to wait on."""
        t0 = time.perf_counter()
        with span("trainer.block"):
            if self._best_dev is None:
                self._best_dev = torch.full((), lowest_train, dtype=self.model.dtype,
                                            device=self.device)
            best_params, best_opt = self._snapshot()
        trl, tel, skl = [], [], []
        for epoch in range(start, start + k):
            with span("trainer.epoch"):
                train_loss, skipped = self._train_epoch(ds, batch_size, epoch)
                tel.append(self._eval_epoch(ds, batch_size, epoch))
                trl.append(train_loss)
                skl.append(skipped)
                with span("trainer.block"):
                    improved = train_loss < self._best_dev
                    self._best_dev = torch.where(improved, train_loss, self._best_dev)
                    params, opt = self._snapshot()
                    best_params = [torch.where(improved, n, b)
                                   for n, b in zip(params, best_params)]
                    best_opt = {i: {key: torch.where(improved, n, best_opt[i][key])
                                    for key, n in st.items()}
                                for i, st in opt.items()}
        with span("trainer.block"):
            host = {
                "train": host_copy(torch.stack(trl)), "test": host_copy(torch.stack(tel)),
                "skipped": host_copy(torch.stack(skl)) if self._guard else None,
                "best": host_copy(self._best_dev),
                "params": [host_copy(t) for t in best_params],
                "opt": {i: {key: host_copy(t) for key, t in st.items()}
                        for i, st in best_opt.items()},
            }
            return start, k, t0, host, ready_event(self.device)

    def _snapshot(self):
        """Copies of the live params and of the optimizer's per-leaf state
        on the device, in ``state_dict()``'s leaf numbering."""
        params = [t.detach().clone() for t in self.params.tensors()]
        opt = {i: {key: t.clone() for key, t in self.optimizer.state[p].items()}
               for i, p in enumerate(self.params.tensors())}
        return params, opt

    def _process_block(self, handles, lowest_train: float, steps_per_epoch: int,
                       t_next: float | None = None) -> float:
        """The host half of a block: wait for its copies alone (the next
        block keeps running), log each epoch with the block's time over
        k, save the best checkpoint if the block improved on
        ``lowest_train``; returns the new best train loss. The block's
        time runs from its dispatch to ``t_next``, the next block's
        dispatch, when one was issued before this read-back (C10: the
        host issues a block as long as the block runs, so the read-back
        comes a block late), else to the read-back."""
        start, k, t0, host, event = handles
        if event is not None:
            with span("trainer.readback"):
                event.synchronize()
        dt = ((time.perf_counter() if t_next is None else t_next) - t0) / k
        for j in range(k):
            if self._guard:
                self._note_skipped(int(host["skipped"][j]))
            self._log_epoch(start + j, float(host["train"][j]), float(host["test"][j]), dt,
                            steps_per_epoch)
        best = float(host["best"])
        if best < lowest_train:
            self._save(checkpoint.BEST, {
                "params": host["params"],
                "opt_state": dict(self.optimizer.state_dict(), state=host["opt"])})
            lowest_train = best
        return lowest_train
