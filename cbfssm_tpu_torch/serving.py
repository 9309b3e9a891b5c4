"""Batch predictors for serving (port of ``CompiledPredictor``,
``BucketedPredictor``, ``_CoalescingBatcher``, ``MicroBatcher`` and
``validate_params_like`` of ``cbfssm_tpu/serving.py``).

PyTorch runs eagerly, so :class:`CompiledPredictor` is a fixed-shape
predictor with the JAX class's shape checks and no ahead-of-time
compile. Random draws come from a ``torch.Generator`` made per call from
an integer seed; :func:`fold_seed` plays the part of
``jax.random.fold_in`` and gives every chunk of a request, and every
coalesced batch, a generator of its own.

Both predictors hot-swap their checkpoint (``reload_params``): the new
params are checked against the served ones (:func:`validate_params_like`),
copied to the predictor's own device, and swapped in as one reference,
so a batch in flight runs on the old params or the new ones, never a
mix. :func:`params_to_leaves` / :func:`params_from_leaves` give a params
tree as the flat list of arrays that the JAX package's
``jax.tree_util.tree_flatten`` gives for the same model (its layout and
order), the wire format of ``POST /v1/params``.

``BucketedPredictor.plan_buckets`` / ``from_histogram`` are not ported:
their default cost model is a TPU measurement.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import typing
from concurrent.futures import Future

import numpy as np
import torch

from cbfssm_tpu_torch import convert
from cbfssm_tpu_torch.models.base import PredictOutput
from cbfssm_tpu_torch.models.cbfssm import CBFSSMParams
from cbfssm_tpu_torch.models.cbfssmhalf import CBFSSMHALFParams
from cbfssm_tpu_torch.models.prssm import PRSSMParams
from cbfssm_tpu_torch.models.voliro import VoliroParams


def fold_seed(seed: int, index: int) -> int:
    """A child seed for stream ``index`` of ``seed``: distinct, well-mixed
    64-bit seeds for distinct (seed, index) pairs."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0])


def check_predict_output(model) -> None:
    """Raise a ``TypeError`` unless ``model.predict`` declares that it
    returns a ``PredictOutput``, the type the batch predictors pad,
    slice and chunk (Voliro's predict returns a dict). Read from the
    return annotation, before any dispatch."""
    declared = typing.get_type_hints(type(model).predict).get("return")
    if not (isinstance(declared, type) and issubclass(declared, PredictOutput)):
        name = getattr(declared, "__name__", repr(declared))
        raise TypeError(
            f"{type(model).__name__}.predict returns {name}, not a PredictOutput; the "
            "batch predictors (CompiledPredictor/BucketedPredictor/MicroBatcher) "
            "support models whose predict returns a PredictOutput "
            "(CBFSSM/CBFSSMHALF/PRSSM)"
        )


# params class -> (to the JAX package's nested numpy tree, back)
_JAX_TREES = {
    CBFSSMParams: (convert.cbfssm_params_to_numpy, convert.cbfssm_params_from_numpy),
    CBFSSMHALFParams: (convert.cbfssmhalf_params_to_numpy,
                       convert.cbfssmhalf_params_from_numpy),
    PRSSMParams: (convert.prssm_params_to_numpy, convert.prssm_params_from_numpy),
    VoliroParams: (convert.voliro_params_to_numpy, convert.voliro_params_from_numpy),
}


def _jax_tree(params):
    try:
        to_numpy, _ = _JAX_TREES[type(params)]
    except KeyError:
        raise TypeError(f"no JAX leaf order for {type(params).__name__}") from None
    return to_numpy(params)


def _tree_leaves(tree, sort: bool = False) -> list:
    """The leaves in ``jax.tree_util`` flatten order: a params dataclass
    (the top level, and each GP's leaves) in field order, which is the
    converted tree's key order; the flax ``recog`` dicts by sorted key."""
    if not isinstance(tree, dict):
        return [tree]
    keys = sorted(tree) if sort else list(tree)
    return [leaf for k in keys for leaf in _tree_leaves(tree[k], sort or k == "recog")]


def _tree_replace(tree, leaves, sort: bool = False):
    """``tree`` with its leaves taken in :func:`_tree_leaves` order from
    the iterator ``leaves``."""
    if not isinstance(tree, dict):
        return next(leaves)
    keys = sorted(tree) if sort else list(tree)
    out = {k: _tree_replace(tree[k], leaves, sort or k == "recog") for k in keys}
    return {k: out[k] for k in tree}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def params_to_leaves(params) -> list:
    """``params`` as host numpy arrays in the layout and order of
    ``jax.tree_util.tree_leaves`` of the JAX package's params of the
    same model (the recognition net in flax's layout)."""
    return [np.asarray(a) for a in _tree_leaves(_jax_tree(params))]


def params_from_leaves(template, leaves, context: str = "reload_params"):
    """Params of ``template``'s structure, device and dtype from
    :func:`params_to_leaves`-ordered arrays (e.g. a params ``.npz`` the
    JAX package's ``post_params_npz`` wrote). Raises a ``ValueError``
    naming the first leaf whose shape or dtype differs from the
    template's."""
    want = params_to_leaves(template)
    if len(leaves) != len(want):
        raise ValueError(
            f"{context}: got {len(leaves)} parameter leaves, serving expects {len(want)} — "
            "wrong model class or config?")
    arrays = []
    for i, (o, n) in enumerate(zip(want, leaves)):
        n = np.asarray(n)
        if n.shape != o.shape or n.dtype != o.dtype:
            raise ValueError(
                f"{context}: leaf {i} is {n.dtype}{list(n.shape)}, serving expects "
                f"{o.dtype}{list(o.shape)} — wrong checkpoint (different dims/inducing "
                "points/dtype)?")
        arrays.append(n)
    _, from_numpy = _JAX_TREES[type(template)]
    leaf0 = template.tensors()[0]
    tree = _tree_replace(_jax_tree(template), iter(arrays))
    return from_numpy(tree, device=leaf0.device, dtype=leaf0.dtype)


def _structure(params):
    recog = getattr(params, "recog", None)
    return (type(params).__name__, len(params.tensors()),
            tuple(recog) if isinstance(recog, dict) else None)


def validate_params_like(old, new, context: str = "reload_params"):
    """Check a replacement params tree against the served one: the same
    class and leaves (structure), each leaf of the same shape and dtype.
    Returns the new tree's leaves copied onto the served params' device
    (the predictor's own, wherever ``new`` lives). A wrong checkpoint
    fails here with the leaf named."""
    if type(new) is not type(old) or _structure(new) != _structure(old):
        got = _structure(new) if hasattr(new, "tensors") else type(new).__name__
        raise ValueError(
            f"{context}: parameter tree structure differs from the served one (got {got}, "
            f"serving {_structure(old)}) — wrong model class or config?")
    coerced = []
    for i, (o, n) in enumerate(zip(old.tensors(), new.tensors())):
        if tuple(n.shape) != tuple(o.shape) or n.dtype != o.dtype:
            raise ValueError(
                f"{context}: leaf {i} is {_dtype_name(n.dtype)}{list(n.shape)}, serving "
                f"expects {_dtype_name(o.dtype)}{list(o.shape)} — wrong checkpoint "
                "(different dims/inducing points/dtype)?")
        coerced.append(n.detach().to(device=o.device, copy=True))
    return old.with_tensors(coerced)


class CompiledPredictor:
    """Free-running prediction for one fixed (batch, seq_len) shape.

    >>> pred = CompiledPredictor(model, params, batch=1, seq_len=300)
    >>> out = pred(u, y)   # PredictOutput of tensors on the model's device
    """

    def __init__(self, model, params, batch: int, seq_len: int,
                 condition: bool = False, seed: int = 0):
        check_predict_output(model)
        self.model = model
        self.params = params
        self.batch = batch
        self.seq_len = seq_len
        self.condition = condition
        self.seed = seed

    def reload_params(self, params) -> None:
        """Hot-swap the served checkpoint: validated
        (:func:`validate_params_like`), copied to the model's device and
        assigned as one reference, so a concurrent call sees the old or
        the new params, never a mix."""
        self.params = validate_params_like(self.params, params)

    def __call__(self, u, y, seed: int | None = None):
        return self._run(self.params, u, y, seed)

    def _run(self, params, u, y, seed):
        model = self.model
        kw = dict(dtype=model.dtype, device=model.device)
        u = torch.as_tensor(u, **kw)
        y = torch.as_tensor(y, **kw)
        want_u = (self.batch, self.seq_len, model.dim_u)
        want_y = (self.batch, self.seq_len, model.dim_y)
        if tuple(u.shape) != want_u:
            raise ValueError(f"built for u {want_u}, got {tuple(u.shape)}")
        if tuple(y.shape) != want_y:
            raise ValueError(f"built for y {want_y}, got {tuple(y.shape)}")
        generator = torch.Generator(device=model.device)
        generator.manual_seed(self.seed if seed is None else int(seed))
        with torch.inference_mode():
            return model.predict(params, u, y, generator, condition=self.condition)


class BucketedPredictor:
    """Serves any request size over a ladder of fixed batch buckets.

    A request is padded with zero rows up to the smallest bucket that
    holds it; one larger than the top bucket is chunked through it, each
    chunk with a generator of its own. Row i of a padded batch does not
    depend on the pad rows: the noise draws are indexed by row position
    and GP rows are predicted independently. The scalar ``mse`` is
    recomputed over the real rows only. Results are numpy arrays.

    >>> pred = BucketedPredictor(model, params, seq_len=300, buckets=(1, 8, 32))
    >>> out = pred(u, y)        # u: [n, 300, du] for any n >= 1
    """

    def __init__(self, model, params, seq_len: int, buckets=(1, 8, 32),
                 condition: bool = False, seed: int = 0):
        if not buckets:
            raise ValueError("need at least one bucket size")
        self.buckets = sorted(set(int(b) for b in buckets))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {buckets}")
        self.seq_len = seq_len
        self.model = model
        self.params = params
        self.seed = seed
        self._preds = {
            b: CompiledPredictor(model, params, b, seq_len, condition, seed)
            for b in self.buckets
        }

    def reload_params(self, params) -> None:
        """Hot-swap the served checkpoint of every bucket. Validated once
        (an invalid one changes nothing); a request reads the params
        reference once, so all its chunks run on one checkpoint."""
        new = validate_params_like(self.params, params)
        self.params = new
        for pred in self._preds.values():
            pred.params = new

    def _one_batch(self, u, y, seed, params=None):
        """Pad one <= top-bucket request up to its bucket, predict with
        ``params`` (default: the served ones), and slice the real rows
        back out (as host arrays)."""
        n = u.shape[0]
        bucket = next(b for b in self.buckets if b >= n)
        pad = bucket - n
        if pad:
            u = np.concatenate([u, np.zeros((pad,) + u.shape[1:], u.dtype)])
            y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        params = self.params if params is None else params
        out = self._preds[bucket]._run(params, u, y, seed).map(lambda a: a.cpu().numpy())
        if pad:
            out = out.map(lambda a: a[:n] if a.ndim else a)
        return out

    def __call__(self, u, y, seed: int | None = None):
        u = np.asarray(u, dtype=self.model.np_dtype)
        y = np.asarray(y, dtype=self.model.np_dtype)
        if u.ndim != 3 or u.shape[1:] != (self.seq_len, self.model.dim_u):
            raise ValueError(
                f"expected [n, {self.seq_len}, {self.model.dim_u}] input, got {u.shape}"
            )
        if y.ndim != 3 or y.shape != (u.shape[0], self.seq_len, self.model.dim_y):
            raise ValueError(
                f"y must be [{u.shape[0]}, {self.seq_len}, "
                f"{self.model.dim_y}] to match u, got {y.shape}"
            )
        if u.shape[0] == 0:
            raise ValueError("need at least one sequence per request")
        top = self.buckets[-1]
        base = self.seed if seed is None else int(seed)
        params = self.params  # one reference for every chunk (reload_params)
        outs = [
            self._one_batch(u[i:i + top], y[i:i + top], fold_seed(base, i // top), params)
            for i in range(0, u.shape[0], top)
        ]
        out = outs[0]
        if len(outs) > 1:
            fields = [[getattr(o, f) for o in outs] for f in vars(out)]
            out = type(out)(*(
                np.concatenate(a, axis=0) if a[0].ndim else a[0] for a in fields
            ))
        # the per-chunk scalar mse is not the request-level number
        mse = np.mean((out.pred_mean - y[..., : out.pred_mean.shape[-1]]) ** 2)
        return out.replace(mse=np.asarray(mse, dtype=out.pred_mean.dtype))


class _CoalescingBatcher:
    """Queue, shutdown and coalescing machinery of :class:`MicroBatcher`.

    - ``_enqueue`` serializes against ``close()`` (the submit lock): a
      producer that passed the ``_closing`` check must never enqueue
      behind the shutdown sentinel, or its future would never resolve;
    - ``close(drain=False)`` fails every pending future before planting
      the sentinel; with ``drain`` the dispatcher serves the backlog
      first;
    - the dispatcher runs a defensive post-sentinel sweep anyway;
    - ``_collect`` blocks for the first item then coalesces until the
      ``max_wait`` deadline or ``_collect_cap()`` items.

    Subclasses provide ``_collect_cap()`` and ``_serve(batch)`` and
    enqueue item tuples whose last two fields are ``(future,
    enqueue_timestamp)``.
    """

    def __init__(self, max_wait_ms: float, queue_size: int, stats: dict,
                 thread_name: str):
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.max_wait = float(max_wait_ms) / 1e3
        self._queue: _queue.Queue = _queue.Queue(maxsize=queue_size)
        self._closing = False
        self._lock = threading.Lock()
        # serializes enqueue vs shutdown; separate from _lock so a
        # producer blocked on backpressure never delays stats() readers
        self._submit_lock = threading.Lock()
        self._stats = dict(stats)
        # started last: the dispatcher never observes a half-built self
        self._thread = threading.Thread(
            target=self._dispatch_loop, name=thread_name, daemon=True
        )
        self._thread.start()

    def _enqueue(self, item) -> None:
        with self._submit_lock:
            if self._closing:
                raise RuntimeError(f"{type(self).__name__} is closed")
            self._queue.put(item)

    def close(self, drain: bool = True) -> None:
        """Stop accepting work and shut the dispatcher down. With
        ``drain`` (default) pending items are served first; otherwise
        their futures get a RuntimeError."""
        with self._submit_lock:
            already = self._closing
            self._closing = True
            if not already:
                if not drain:
                    try:
                        while True:
                            *_, fut, _t = self._queue.get_nowait()
                            if fut.set_running_or_notify_cancel():
                                fut.set_exception(RuntimeError(
                                    f"{type(self).__name__} closed before dispatch"
                                ))
                    except _queue.Empty:
                        pass
                self._queue.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --- dispatcher thread ----------------------------------------------

    def _collect(self):
        """Block for the first item, then coalesce until
        ``_collect_cap()`` items or the max_wait deadline. Returns a list
        of queue items, or None at the shutdown sentinel."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        cap = self._collect_cap()
        while len(batch) < cap:
            remaining = deadline - time.perf_counter()
            try:
                item = (
                    self._queue.get_nowait()
                    if remaining <= 0
                    else self._queue.get(timeout=remaining)
                )
            except _queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # keep the sentinel for loop exit
                break
            batch.append(item)
        return batch

    def _dispatch_loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                try:
                    while True:
                        item = self._queue.get_nowait()
                        if item is None:
                            continue
                        *_, fut, _t = item
                        if fut.set_running_or_notify_cancel():
                            fut.set_exception(RuntimeError(
                                f"{type(self).__name__} closed before dispatch"
                            ))
                except _queue.Empty:
                    return
                continue
            self._serve(batch)

    def _collect_cap(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def _serve(self, batch) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class MicroBatcher(_CoalescingBatcher):
    """Request-coalescing front-end for a batch predictor.

    Callers :meth:`submit` one ``[T, du]`` / ``[T, dy]`` sequence each
    and receive a ``concurrent.futures.Future``; one dispatcher thread
    coalesces queued requests into batches bounded by ``max_batch`` and
    ``max_wait_ms``, serves each batch in one predictor call, and fans
    the rows back out on the host. All device work runs on that thread.
    Each batch gets the generator seed ``fold_seed(seed, batch_index)``.

    The predictor must accept ``(u [n, T, du], y [n, T, dy], seed)`` for
    any ``n >= 1``, return numpy leaves, and expose ``.model`` and
    ``.seq_len``: a :class:`BucketedPredictor`.

    >>> mb = MicroBatcher(BucketedPredictor(model, params, seq_len=300))
    >>> fut = mb.submit(u_seq, y_seq)   # from any thread
    >>> out = fut.result()              # PredictOutput, numpy [1, T, .]
    >>> mb.close()                      # or use as a context manager
    """

    def __init__(self, predictor, max_batch: int = 32,
                 max_wait_ms: float = 2.0, queue_size: int = 1024,
                 seed: int = 0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.seed = int(seed)
        self._batch_idx = 0
        super().__init__(max_wait_ms, queue_size, {
            "requests": 0, "batches": 0, "errors": 0,
            "batched_rows": 0, "max_batch_seen": 0, "wait_s": 0.0,
        }, "cbfssm-microbatcher")

    # --- client side ----------------------------------------------------

    def submit(self, u, y) -> Future:
        """Enqueue one sequence; returns a Future resolving to the
        request's PredictOutput (leaves ``[1, T, .]``, ``mse`` over this
        request alone). Thread-safe; blocks when ``queue_size`` requests
        are pending."""
        model = self.predictor.model
        seq_len = self.predictor.seq_len
        u = np.asarray(u, dtype=model.np_dtype)
        y = np.asarray(y, dtype=model.np_dtype)
        if u.shape != (seq_len, model.dim_u):
            raise ValueError(
                f"u must be [{seq_len}, {model.dim_u}] (one sequence), got {u.shape}"
            )
        if y.shape != (seq_len, model.dim_y):
            raise ValueError(f"y must be [{seq_len}, {model.dim_y}] to match u, got {y.shape}")
        fut: Future = Future()
        self._enqueue((u, y, fut, time.perf_counter()))
        return fut

    def __call__(self, u, y, timeout=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(u, y).result(timeout)

    def stats(self) -> dict:
        """requests, batches, errors, mean_batch_size, max_batch_seen,
        mean_wait_ms."""
        with self._lock:
            s = dict(self._stats)
        n, b = s.pop("batched_rows"), s["batches"]
        wait = s.pop("wait_s")
        s["mean_batch_size"] = n / b if b else 0.0
        s["mean_wait_ms"] = 1e3 * wait / n if n else 0.0
        return s

    # --- dispatcher thread ----------------------------------------------

    def _collect_cap(self) -> int:
        return self.max_batch

    def _serve(self, batch) -> None:
        t_dispatch = time.perf_counter()
        live = [(u, y, f, t) for (u, y, f, t) in batch if f.set_running_or_notify_cancel()]
        with self._lock:
            self._stats["requests"] += len(batch)
            if live:
                self._stats["batches"] += 1
                self._stats["batched_rows"] += len(live)
                self._stats["max_batch_seen"] = max(self._stats["max_batch_seen"], len(live))
                self._stats["wait_s"] += sum(t_dispatch - t for *_, t in live)
        if not live:
            return
        # consume the batch index even if the dispatch fails, so seeds
        # stay independent across batches
        key_idx, self._batch_idx = self._batch_idx, self._batch_idx + 1
        try:
            u = np.stack([u for u, *_ in live])
            y = np.stack([y for _, y, *_ in live])
            out = self.predictor(u, y, fold_seed(self.seed, key_idx))
            pred_mean = out.pred_mean
            for i, (_, y_i, fut, _t) in enumerate(live):
                mse_i = np.mean((pred_mean[i] - y_i[:, : pred_mean.shape[-1]]) ** 2)
                row = out.map(lambda a: a[i:i + 1] if a.ndim else a)
                fut.set_result(row.replace(mse=np.asarray(mse_i, dtype=pred_mean.dtype)))
        except Exception as exc:
            # rows resolved before a mid-fan-out failure count as served;
            # fail only the pending ones (set_exception on a done future
            # would raise and kill the dispatcher)
            failed = 0
            for *_, fut, _t in live:
                if not fut.done():
                    fut.set_exception(exc)
                    failed += 1
            with self._lock:
                self._stats["errors"] += failed
