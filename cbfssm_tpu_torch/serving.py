"""Serving (port of ``cbfssm_tpu/serving.py``): the batch predictors
``CompiledPredictor``, ``BucketedPredictor`` (with its bucket planner)
and ``MicroBatcher``, the online filters ``StreamingFilter``,
``FilterPool`` and ``FilterBatcher``, and ``validate_params_like``.

PyTorch runs eagerly, so :class:`CompiledPredictor` is a fixed-shape
predictor with the JAX class's shape checks and no ahead-of-time
compile. Random draws come from a ``torch.Generator`` made per call from
an integer seed; :func:`~cbfssm_tpu_torch.streams.fold_seed` plays the
part of ``jax.random.fold_in`` and gives every chunk of a request, and
every coalesced batch, a generator of its own. The seed, draw and
replay-chunk helpers live in :mod:`cbfssm_tpu_torch.streams` (shared
with the artifact loaders) and are importable from here.

Both predictors hot-swap their checkpoint (``reload_params``): the new
params are checked against the served ones (:func:`validate_params_like`),
copied to the predictor's own device, and swapped in as one reference,
so a batch in flight runs on the old params or the new ones, never a
mix. :func:`params_to_leaves` / :func:`params_from_leaves` give a params
tree as the flat list of arrays that the JAX package's
``jax.tree_util.tree_flatten`` gives for the same model (its layout and
order), the wire format of ``POST /v1/params`` and of an artifact's
``params.npz``; :func:`params_to_tensors` / :func:`params_from_tensors`
are the same in torch ops, which ``torch.export`` traces.

This module imports no model: the model classes are read where a
params tree meets the JAX package's layout (:func:`params_to_leaves`),
so a process that serves an exported artifact never loads them.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import typing
from concurrent.futures import Future

import numpy as np
import torch

from cbfssm_tpu_torch.parallel.local import LocalMesh, canonical_device, model_on, replica
from cbfssm_tpu_torch.predict_output import PredictOutput
from cbfssm_tpu_torch.streams import (fold_seed, iter_replay_chunks,  # noqa: F401 (re-exported)
                                      key_seed, normal_draws, normalize_replay_ladder,
                                      plan_replay_chunks, seed_key)


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


def _jax_tree_fns(params):
    """(to the JAX package's nested numpy tree, back) for the class of
    ``params``: the converters of :mod:`cbfssm_tpu_torch.convert`,
    imported here and not with this module (they import the models)."""
    from cbfssm_tpu_torch import convert
    from cbfssm_tpu_torch.models.cbfssm import CBFSSMParams
    from cbfssm_tpu_torch.models.cbfssmhalf import CBFSSMHALFParams
    from cbfssm_tpu_torch.models.prssm import PRSSMParams
    from cbfssm_tpu_torch.models.voliro import VoliroParams

    trees = {
        CBFSSMParams: (convert.cbfssm_params_to_numpy, convert.cbfssm_params_from_numpy),
        CBFSSMHALFParams: (convert.cbfssmhalf_params_to_numpy,
                           convert.cbfssmhalf_params_from_numpy),
        PRSSMParams: (convert.prssm_params_to_numpy, convert.prssm_params_from_numpy),
        VoliroParams: (convert.voliro_params_to_numpy, convert.voliro_params_from_numpy),
    }
    try:
        return trees[type(params)]
    except KeyError:
        raise TypeError(f"no JAX leaf order for {type(params).__name__}") from None


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
    to_numpy, _ = _jax_tree_fns(params)
    return [np.asarray(a) for a in _tree_leaves(to_numpy(params))]


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
    to_numpy, from_numpy = _jax_tree_fns(template)
    leaf0 = template.tensors()[0]
    tree = _tree_replace(to_numpy(template), iter(arrays))
    return from_numpy(tree, device=leaf0.device, dtype=leaf0.dtype)


_GRU_GATES = ("r", "z", "n")  # torch's order of the gates in a GRU weight


def _flax_recognition(recog: dict) -> dict:
    """The flax tree of the port's recognition leaves (``{}`` for
    'output'), in torch ops: the layout ``convert`` gives the JAX
    package (the GRU gates split and transposed, the conv kernel as
    ``[3, d, 5]``, the Dense kernel transposed)."""
    if not recog:
        return {}
    if "cell.weight_ih" in recog:
        h = recog["cell.bias_hn"].shape[-1]
        cell = {}
        for j, g in enumerate(_GRU_GATES):
            rows = slice(j * h, (j + 1) * h)
            cell["i" + g] = {"kernel": recog["cell.weight_ih"][..., rows, :].mT,
                             "bias": recog["cell.bias_ih"][..., rows]}
            cell["h" + g] = {"kernel": recog["cell.weight_hh"][..., rows, :].mT}
        cell["hn"]["bias"] = recog["cell.bias_hn"]
        params = {"GRUCell_0": cell}
    else:
        params = {"Conv_0": {"kernel": recog["conv.weight"].transpose(-1, -3),
                             "bias": recog["conv.bias"]}}
    params["Dense_0"] = {"kernel": recog["readout.weight"].mT, "bias": recog["readout.bias"]}
    return {"params": params}


def _flax_skeleton(recog: dict) -> dict:
    """The keys of :func:`_flax_recognition`'s tree, every leaf None,
    read off the leaf names alone: a trace records nothing for it."""
    if not recog:
        return {}
    if "cell.weight_ih" in recog:
        cell = {"i" + g: {"kernel": None, "bias": None} for g in _GRU_GATES}
        cell.update({"h" + g: {"kernel": None} for g in _GRU_GATES})
        cell["hn"]["bias"] = None
        params = {"GRUCell_0": cell}
    else:
        params = {"Conv_0": {"kernel": None, "bias": None}}
    params["Dense_0"] = {"kernel": None, "bias": None}
    return {"params": params}


def _port_recognition(tree: dict) -> dict:
    """The inverse of :func:`_flax_recognition`: the port's recognition
    leaves by name, contiguous."""
    if not tree:
        return {}
    params = tree["params"]
    if "GRUCell_0" in params:
        cell = params["GRUCell_0"]

        def gates(kind, leaf):
            return torch.cat([cell[kind + g][leaf] for g in _GRU_GATES], dim=-1)

        leaves = {"cell.weight_ih": gates("i", "kernel").mT, "cell.bias_ih": gates("i", "bias"),
                  "cell.weight_hh": gates("h", "kernel").mT, "cell.bias_hn": cell["hn"]["bias"]}
    else:
        leaves = {"conv.weight": params["Conv_0"]["kernel"].transpose(-1, -3),
                  "conv.bias": params["Conv_0"]["bias"]}
    leaves["readout.weight"] = params["Dense_0"]["kernel"].mT
    leaves["readout.bias"] = params["Dense_0"]["bias"]
    return {k: v.contiguous() for k, v in leaves.items()}


def params_to_tensors(params) -> list:
    """``params`` as contiguous tensors (on their own device) in the
    layout and order of :func:`params_to_leaves`, computed in torch ops
    without the model classes: the leaves of ``params.tensors()``, with
    the recognition net's in flax's layout and sorted order."""
    tensors = params.tensors()
    recog = getattr(params, "recog", None)
    if recog:
        flax = _tree_leaves(_flax_recognition(recog), sort=True)
        tensors = tensors[:len(tensors) - len(recog)] + flax
    return [t.contiguous() for t in tensors]


def params_from_tensors(template, tensors):
    """Params of ``template``'s structure from
    :func:`params_to_tensors`-ordered tensors, in torch ops only, so
    that ``torch.export`` traces a program's params as this flat tuple
    (the tensors stay where they are: nothing is copied to the
    template's device or dtype)."""
    tensors = list(tensors)
    recog = getattr(template, "recog", None)
    if recog:
        n = len(template.tensors()) - len(recog)
        flax = _tree_replace(_flax_skeleton(recog), iter(tensors[n:]), sort=True)
        port = _port_recognition(flax)
        tensors = tensors[:n] + [port[k] for k in recog]
    return template.with_tensors(tensors)


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

    # The (fixed, per-row) cost of one dispatch in units of the fixed cost,
    # measured on an H100 (NVIDIA H100 80GB HBM3, 700.00 W) by
    # chip_smoke.py phase 11 (d): the CBFSSM predictor at the RoboMove
    # width, float32, 15 rounds over B = 1, 2, 4, 8, 16, 32, least squares
    # ms = 102.0748 + 0.16074 B (standard error 0.05202). A row costs
    # ~1.6e-3 of a dispatch (runs on other hosts gave 3.6e-4 and 5.7e-4,
    # inside their noise): host dispatch, not rows, sets the time, so
    # padding is nearly free.
    MEASURED_COST = (1.0, 1.575e-3)

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

    @staticmethod
    def plan_buckets(sizes, max_buckets: int, cost=None):
        """The bucket ladder of least expected cost for a traffic
        histogram.

        ``sizes``: observed request sizes (one entry per request).
        ``max_buckets``: how many buckets the ladder may hold. ``cost``:
        the (fixed, per_row) cost of one dispatch; default
        :attr:`MEASURED_COST`.

        Exact O(S^2 k) partition DP over the S distinct sizes: a request
        is served by the smallest bucket that holds it, so a ladder
        partitions the sorted sizes into groups whose bucket is the
        group's largest size; the DP minimizes the sum over requests of
        ``fixed + per_row * bucket(size)``. Larger requests chunk
        through the top bucket at serve time, so the plan covers
        ``max(sizes)`` exactly.
        """
        sizes = np.asarray(sizes, dtype=np.int64).ravel()
        if sizes.size == 0:
            raise ValueError("need at least one observed request size")
        if (sizes < 1).any():
            raise ValueError("request sizes must be >= 1")
        if max_buckets < 1:
            raise ValueError("max_buckets must be >= 1")
        c0, c1 = cost if cost is not None else BucketedPredictor.MEASURED_COST
        uniq, counts = np.unique(sizes, return_counts=True)
        s = len(uniq)
        k = min(int(max_buckets), s)
        csum = np.concatenate(([0], np.cumsum(counts)))  # prefix counts
        dp = np.full((s + 1, k + 1), float("inf"))
        dp[0, 0] = 0.0
        cut = np.zeros((s + 1, k + 1), dtype=np.int64)
        for j in range(1, s + 1):
            bucket_cost = c0 + c1 * float(uniq[j - 1])
            for m in range(1, k + 1):
                for i in range(j):
                    cand = dp[i, m - 1] + (csum[j] - csum[i]) * bucket_cost
                    if cand < dp[j, m]:
                        dp[j, m] = cand
                        cut[j, m] = i
        m = int(np.argmin(dp[s, 1:])) + 1  # more buckets never cost more
        buckets = []
        j = s
        while m > 0:
            buckets.append(int(uniq[j - 1]))
            j = int(cut[j, m])
            m -= 1
        return sorted(buckets)

    @staticmethod
    def expected_cost(buckets, sizes, cost=None):
        """Mean cost per request of a ladder under the cost model
        (requests above the top bucket chunk through it): what
        :meth:`plan_buckets` minimizes."""
        c0, c1 = cost if cost is not None else BucketedPredictor.MEASURED_COST
        buckets = sorted(set(int(b) for b in buckets))
        top = buckets[-1]
        total = 0.0
        for n in np.asarray(sizes, dtype=np.int64).ravel():
            full, rest = divmod(int(n), top)
            total += full * (c0 + c1 * top)
            if rest:
                b = next(b for b in buckets if b >= rest)
                total += c0 + c1 * b
        return total / max(1, np.asarray(sizes).size)

    @classmethod
    def from_histogram(cls, model, params, seq_len: int, sizes, max_buckets: int = 3,
                       cost=None, condition: bool = False, seed: int = 0):
        """A predictor whose ladder :meth:`plan_buckets` chose for an
        observed traffic histogram."""
        buckets = cls.plan_buckets(sizes, max_buckets, cost)
        return cls(model, params, seq_len, buckets=buckets, condition=condition, seed=seed)

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


def _host(t) -> np.ndarray:
    """A host numpy copy of a tensor (never a view of a CPU tensor that
    a later in-place update would change)."""
    return t.detach().to("cpu", copy=True).numpy()


class _Filter:
    """What :class:`StreamingFilter` and :class:`FilterPool` share: the
    streaming-interface check, params on the model's device, the
    operators, the base key and the draw schedule."""

    def __init__(self, model, params, seed: int, owner: str, replay_buckets):
        # filter_replay is checked at replay use (and for a ladder here):
        # a model with the four-method contract serves without it
        for attr in ("filter_ops", "filter_init", "filter_step", "forecast"):
            if not hasattr(model, attr):
                raise TypeError(
                    f"{type(model).__name__} has no streaming interface "
                    f"({attr}); {owner} supports CBFSSMHALF and Voliro"
                )
        self.model = model
        self.params = params.with_tensors(
            [t.detach().to(model.device) for t in params.tensors()])
        self._base_key = seed_key(seed)
        self._ops = self._filter_ops()
        self._replay_buckets = normalize_replay_ladder(replay_buckets)
        if self._replay_buckets:
            self._require_replay()

    def _filter_ops(self):
        with torch.no_grad():
            return self.model.filter_ops(self.params)

    def _require_replay(self):
        if not hasattr(self.model, "filter_replay"):
            raise TypeError(
                f"{type(self.model).__name__} has no filter_replay; "
                "fused backlog replay supports CBFSSMHALF and Voliro"
            )

    def _dev(self, a):
        """A host array as a tensor on the model's device, in its dtype."""
        return torch.as_tensor(a, dtype=self.model.dtype, device=self.model.device)

    def _draw_shape(self, lead, b: int):
        """The ``eps=`` shape of ``filter_step`` (``lead`` empty) or of
        ``forecast`` (``lead = (H,)``) at batch ``b``: ``lead + (b, S,
        1)``, with a ``FILTER_DRAWS`` axis before ``b`` for a model whose
        step takes more than one draw (Voliro: force, state)."""
        draws = getattr(self.model, "FILTER_DRAWS", 1)
        return tuple(lead) + ((draws,) if draws > 1 else ()) + (b, self.model.samples, 1)

    def _draws(self, index: int, shape):
        """Standard-normal draws of tick ``index``: ``shape`` from a
        ``torch.Generator`` on the model's device seeded
        ``fold_seed(key_seed(base key), index)``. Updates and steps use
        the tick, forecasts ``2**30 + tick`` (the JAX key fold's
        indices)."""
        return normal_draws(self._base_key, index, shape, self.model.dtype, self.model.device)

    def _replay_draws(self, t0: int, k_prog: int, b: int):
        """``[k_prog, ...]`` draws of a replay chunk starting at tick
        ``t0``: step i takes tick ``t0 + i``'s draws, exactly those of
        the sequential updates (padded steps draw too, and are held)."""
        shape = self._draw_shape((), b)
        return torch.stack([self._draws(t0 + i, shape) for i in range(k_prog)])

    @staticmethod
    def _restore_key(key, current):
        """Validated key restore shared by the failover loaders: None
        (legacy snapshot) keeps the instance's own key; otherwise the
        snapshot's key must be a uint32[2] like ``current``."""
        if key is None:
            return current
        key = np.asarray(key)
        want = (np.asarray(current).shape, np.asarray(current).dtype)
        if (key.shape, key.dtype) != want:
            raise ValueError(
                f"snapshot key has shape/dtype {(key.shape, key.dtype)}, "
                f"expected {want}"
            )
        return key.copy()


class StreamingFilter(_Filter):
    """Stateful online state estimation: a particle filter over a
    trained CBFSSMHALF (whose conditioning update touches only the
    observed dims) or Voliro (set ``config['filter_dt']``), with the
    ensemble on the model's device.

    >>> f = StreamingFilter(model, params, batch=1)
    >>> f.start(u_prefix, y_prefix)          # recognition net -> x_0
    >>> mean, var = f.update(u_prev, y_new)  # one conditioned transition
    >>> mean, var = f.forecast(u_future)     # free-run ahead, state kept
    >>> mean, var = f.replay(u_blk, y_blk)   # K backlog steps

    ``update`` and ``forecast`` return tensors on the model's device,
    ``replay`` host arrays. ``state`` / ``load_state`` carry the
    ensemble, the step counter and the base key for failover.

    Draws: update ``t`` takes ``eps`` from a generator seeded
    ``fold_seed(seed, t)``, a forecast at counter ``t`` from ``fold_seed(seed,
    2**30 + t)`` (:meth:`_draws`). The base key is the seed as ``uint32[2]``
    (:func:`seed_key`), the words of ``jax.random.PRNGKey(seed)``, so
    snapshots pass between the two packages; the draws themselves
    differ (Philox against threefry). ``replay`` feeds step i the draws
    of update ``t0 + i``, so it equals the sequential updates by
    construction; ``replay_buckets`` chunks a backlog over a ladder of
    lengths (padded steps are masked and launch as well).
    """

    def __init__(self, model, params, batch: int = 1, seed: int = 0,
                 replay_buckets=None):
        super().__init__(model, params, seed, "StreamingFilter", replay_buckets)
        self.batch = batch
        self._x = None
        self._t = 0

    # --- state management ----------------------------------------------

    def reload_params(self, params) -> None:
        """Hot-swap the trained checkpoint without dropping the session:
        the ensemble, step counter and base key carry over. The params
        are validated (:func:`validate_params_like`), copied to the
        filter's device, and ``filter_ops`` is recomputed."""
        self.params = validate_params_like(self.params, params)
        self._ops = self._filter_ops()

    @property
    def state(self):
        """(ensemble [B, S, dx] host array or None, step counter, base
        key uint32[2]). The key rides along so a standby built with
        another seed resumes the primary's draw stream."""
        return (None if self._x is None else _host(self._x), self._t,
                self._base_key.copy())

    def load_state(self, state) -> None:
        if len(state) == 2:  # pre-key snapshots: keep this seed's key
            (x, t), key = state, None
        else:
            x, t, key = state
        if x is not None:
            x = self._dev(x)
            want = (self.batch, self.model.samples, self.model.dim_x)
            if tuple(x.shape) != want:
                raise ValueError(
                    f"ensemble must be {want} for this filter, got {tuple(x.shape)}"
                )
        self._base_key = self._restore_key(key, self._base_key)
        self._x = x
        self._t = int(t)

    def _require_started(self):
        if self._x is None:
            raise RuntimeError("call start(u_prefix, y_prefix) first")

    # --- start, update, replay, forecast ----------------------------------

    def start(self, u_prefix, y_prefix) -> None:
        """Initialize the ensemble from a recog_len warmup window."""
        m = self.model
        u = np.asarray(u_prefix, dtype=m.np_dtype)
        y = np.asarray(y_prefix, dtype=m.np_dtype)
        want = (self.batch, int(m.config.recog_len))
        if u.shape != want + (m.dim_u,):
            raise ValueError(
                f"built for prefix shape {want + (m.dim_u,)}, got u {u.shape}"
            )
        if y.shape != want + (m.dim_y,):
            raise ValueError(
                f"y_prefix must be {want + (m.dim_y,)} to match "
                f"u_prefix, got {y.shape}"
            )
        with torch.no_grad():
            self._x = m.filter_init(self.params, self._dev(u), self._dev(y))
        self._t = 0

    def update(self, u_prev, y_new):
        """Advance one transition conditioned on the arriving
        observation; returns filtered (mean [B, dy], var [B, dy])."""
        self._require_started()
        m = self.model
        u = np.asarray(u_prev, dtype=m.np_dtype)
        y = np.asarray(y_new, dtype=m.np_dtype)
        if u.shape != (self.batch, m.dim_u) or y.shape != (self.batch, m.dim_y):
            raise ValueError(
                f"update expects u [{self.batch}, {m.dim_u}] and "
                f"y [{self.batch}, {m.dim_y}], got {u.shape} / {y.shape}"
            )
        eps = self._draws(self._t, self._draw_shape((), self.batch))
        with torch.no_grad():
            self._x, (mean, var) = m.filter_step(
                self.params, self._ops, self._x, self._dev(u), self._dev(y), eps=eps)
        self._t += 1
        return mean, var

    def replay(self, u_block, y_block):
        """Catch up on a K-step backlog, ``u_block`` [B, K, du] /
        ``y_block`` [B, K, dy], one ``filter_replay`` per bucket chunk.
        Equal to K sequential :meth:`update` calls (the same draws, the
        same step body). Returns host (mean [B, K, dy], var [B, K, dy])."""
        self._require_started()
        self._require_replay()
        m = self.model
        u = np.asarray(u_block, dtype=m.np_dtype)
        y = np.asarray(y_block, dtype=m.np_dtype)
        if u.ndim != 3 or u.shape[0] != self.batch or u.shape[2] != m.dim_u:
            raise ValueError(
                f"u_block must be [{self.batch}, K, {m.dim_u}], got {u.shape}"
            )
        k_total = u.shape[1]
        if y.shape != (self.batch, k_total, m.dim_y):
            raise ValueError(
                f"y_block must be [{self.batch}, {k_total}, "
                f"{m.dim_y}] to match u_block, got {y.shape}"
            )
        means, vars_ = [], []
        for u_c, y_c, active, k_act in iter_replay_chunks(u, y, self._replay_buckets):
            eps = self._replay_draws(self._t, u_c.shape[1], self.batch)
            with torch.no_grad():
                self._x, (mv, vv) = m.filter_replay(
                    self.params, self._ops, self._x, self._dev(u_c), self._dev(y_c),
                    active=torch.as_tensor(active, device=m.device), eps=eps)
            self._t += k_act
            means.append(_host(mv)[:, :k_act])
            vars_.append(_host(vv)[:, :k_act])
        if len(means) == 1:
            return means[0], vars_[0]
        return np.concatenate(means, axis=1), np.concatenate(vars_, axis=1)

    def forecast(self, u_future):
        """Free-run prediction from the current ensemble over
        ``u_future`` [B, H, du]; does not advance the filter state."""
        self._require_started()
        m = self.model
        u = np.asarray(u_future, dtype=m.np_dtype)
        if u.ndim != 3 or u.shape[0] != self.batch or u.shape[2] != m.dim_u:
            raise ValueError(
                f"u_future must be [{self.batch}, H, {m.dim_u}], got {u.shape}"
            )
        eps = self._draws(2**30 + self._t, self._draw_shape((u.shape[1],), self.batch))
        with torch.no_grad():
            return m.forecast(self.params, self._ops, self._x, self._dev(u), eps=eps)


class FilterPool(_Filter):
    """Many independent online-filtering sessions, one batched step.

    The pool packs up to ``capacity`` sessions into the batch axis of
    one ``filter_step``: :meth:`step` advances every participating
    session at once, and computes all ``capacity`` rows (sessions not
    listed hold their rows through a ``torch.where`` mask, which is
    exact). Rows are independent (the draws are indexed by row, the GP
    predicts rows independently), so co-resident sessions never affect
    each other.

    >>> pool = FilterPool(model, params, capacity=32)
    >>> a = pool.attach(u_prefix, y_prefix)      # [recog_len, du/dy]
    >>> out = pool.step({a: (u_a, y_a)})         # {sid: (mean [dy], var [dy])}
    >>> fc = pool.forecast({a: u_future})        # (mean/var [H, dy])
    >>> pool.replay({a: (u_blk, y_blk)})         # ragged backlogs
    >>> pool.detach(a)

    Tick ``t`` of a step draws as :class:`StreamingFilter` update ``t``
    does (one shared ``[capacity, ...]`` draw), a forecast at tick
    ``t`` as its forecast. Not thread-safe: drive it from one loop, or
    through :class:`FilterBatcher`. ``state`` / ``load_state`` carry
    the whole pool (ensemble, tick, session table, base key).

    Fleet scale-out: ``mesh`` (a :func:`~cbfssm_tpu_torch.parallel.local_mesh`
    of this process's devices) shards the capacity axis over its
    ``axis_name`` axis of n devices; ``capacity`` must be a multiple of
    n. Block b holds rows ``[b C/n, (b+1) C/n)`` on device b; params and
    operators are replicated, one copy per distinct device. A tick draws
    the unsharded pool's ``[capacity, ...]`` draw and cuts it into the
    blocks' rows, issues every block's step on its device, and only then
    reads the blocks back: no collective, no sync between blocks. Each
    block computes its rows as the unsharded pool does, so the sessions'
    results are the unsharded pool's (bitwise wherever the ops' per-row
    results do not depend on the row count), and ``state`` is the
    unsharded pool's: a snapshot loads across topologies.
    """

    mesh = None

    def __init__(self, model, params, capacity: int, seed: int = 0,
                 mesh=None, axis_name: str = "data", replay_buckets=None):
        if mesh is not None:
            _check_local_mesh(mesh, axis_name, capacity)
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        super().__init__(model, params, seed, "FilterPool", replay_buckets)
        self.capacity = int(capacity)
        self.mesh = mesh
        self._init_host_state()

    def _init_host_state(self) -> None:
        """The empty fleet: a zero ensemble in every row block, no
        sessions, tick 0, no replicas yet."""
        m = self.model
        self._replicas = {}  # device -> (model, params, ops) on it
        self._x = [torch.zeros((self._rows, m.samples, m.dim_x), dtype=m.dtype, device=dev)
                   for dev in self._devices]
        self._slots: dict = {}  # sid -> slot
        self._free = list(range(self.capacity - 1, -1, -1))  # pop() -> slot 0 first
        self._next_sid = 0
        self._tick = 0

    # --- row blocks --------------------------------------------------------

    @property
    def _devices(self) -> list:
        """The device of each row block: the model's alone, unsharded."""
        if self.mesh is None:
            return [self.model.device]
        return list(self.mesh.devices)

    @property
    def _rows(self) -> int:
        """Rows in one block."""
        return self.capacity // len(self._devices)

    def _block_rows(self, b: int) -> slice:
        return slice(b * self._rows, (b + 1) * self._rows)

    def _replica(self, device):
        """(model, params, ops) for a block on ``device``: the pool's own
        on the model's device, else copies made once (and dropped by
        :meth:`reload_params`)."""
        device = canonical_device(device)
        if device == canonical_device(self.model.device):
            return self.model, self.params, self._ops
        if device not in self._replicas:
            self._replicas[device] = (
                model_on(self.model, device),
                self.params.with_tensors([t.to(device) for t in self.params.tensors()]),
                replica(self._ops, device))
        return self._replicas[device]

    def _blocks(self, *rows_first, draws=None, mask=None):
        """Per block: (b, (model, params, ops), its rows of each tensor of
        ``rows_first`` (axis 0), of ``draws`` (the capacity axis, third
        from the end) and of ``mask`` (axis 1 when 2-D, else 0), each on
        the block's device)."""
        for b, dev in enumerate(self._devices):
            rows = self._block_rows(b)
            cut = [t[rows].to(dev) for t in rows_first]
            if draws is not None:
                cut.append(draws.narrow(-3, rows.start, self._rows).to(dev))
            if mask is not None:
                cut.append((mask[:, rows] if mask.dim() == 2 else mask[rows]).to(dev))
            yield b, self._replica(dev), cut

    def _read_blocks(self, parts):
        """The blocks' outputs read back, one copy each, joined on rows."""
        host = [_host(p) for p in parts]
        return host[0] if len(host) == 1 else np.concatenate(host)

    def _set_row(self, slot: int, value) -> None:
        b, r = divmod(slot, self._rows)
        self._x[b][r] = value

    # --- session management --------------------------------------------

    @property
    def active(self) -> int:
        return len(self._slots)

    def reload_params(self, params) -> None:
        """Hot-swap the fleet's checkpoint without dropping a session:
        ensembles, tick, table and base key carry over. The new params
        are validated and placed on the pool's own device
        (:func:`validate_params_like`), then ``filter_ops`` is
        recomputed there; every block's replica is replaced."""
        self.params = validate_params_like(self.params, params)
        self._ops = self._filter_ops()
        self._replicas = {}

    def attach(self, u_prefix, y_prefix) -> int:
        """Start a session from a recog_len warmup window (the
        recognition net training uses); returns its session id."""
        if not self._free:
            raise RuntimeError(f"pool full ({self.capacity} sessions)")
        m = self.model
        recog_len = int(m.config.recog_len)
        u = np.asarray(u_prefix, dtype=m.np_dtype)
        y = np.asarray(y_prefix, dtype=m.np_dtype)
        if u.shape != (recog_len, m.dim_u):
            raise ValueError(
                f"u_prefix must be [{recog_len}, {m.dim_u}] "
                f"(one session), got {u.shape}"
            )
        if y.shape != (recog_len, m.dim_y):
            raise ValueError(
                f"y_prefix must be [{recog_len}, {m.dim_y}] to "
                f"match u_prefix, got {y.shape}"
            )
        with torch.no_grad():
            x0 = m.filter_init(self.params, self._dev(u[None]), self._dev(y[None]))
            slot = self._free.pop()
            self._set_row(slot, x0[0])
        sid = self._next_sid
        self._next_sid += 1
        self._slots[sid] = slot
        return sid

    def detach(self, sid: int) -> None:
        """End a session; its slot is zeroed and becomes reusable."""
        slot = self._slots.pop(sid)  # KeyError on unknown sid
        self._set_row(slot, 0.0)
        self._free.append(slot)

    # --- step, replay, forecast ------------------------------------------

    def step(self, inputs: dict) -> dict:
        """Advance the sessions in ``inputs``, ``{sid: (u_prev [du],
        y_new [dy])}``, by one conditioned transition; sessions not
        listed hold their state. Returns ``{sid: (mean [dy], var
        [dy])}`` (numpy) of filtered observation-space moments."""
        if not inputs:
            raise ValueError("step() needs at least one session input")
        m = self.model
        u_full = np.zeros((self.capacity, m.dim_u), m.np_dtype)
        y_full = np.zeros((self.capacity, m.dim_y), m.np_dtype)
        mask = np.zeros((self.capacity,), np.bool_)
        for sid, (u, y) in inputs.items():
            slot = self._slots[sid]  # KeyError on unknown sid
            u = np.asarray(u, dtype=m.np_dtype)
            y = np.asarray(y, dtype=m.np_dtype)
            if u.shape != (m.dim_u,) or y.shape != (m.dim_y,):
                raise ValueError(
                    f"session {sid}: expected u [{m.dim_u}] and "
                    f"y [{m.dim_y}], got {u.shape} / {y.shape}"
                )
            u_full[slot], y_full[slot], mask[slot] = u, y, True
        eps = self._draws(self._tick, self._draw_shape((), self.capacity))
        means, vars_ = [], []
        with torch.no_grad():
            # every block is issued before any is read back
            for b, (model, params, ops), (u_b, y_b, eps_b, keep) in self._blocks(
                    self._dev(u_full), self._dev(y_full), draws=eps,
                    mask=torch.as_tensor(mask, device=m.device)):
                x_next, (mean, var) = model.filter_step(params, ops, self._x[b], u_b, y_b,
                                                        eps=eps_b)
                self._x[b] = torch.where(keep[:, None, None], x_next, self._x[b])
                means.append(mean)
                vars_.append(var)
        self._tick += 1
        mean, var = self._read_blocks(means), self._read_blocks(vars_)  # then host fan-out
        return {sid: (mean[self._slots[sid]], var[self._slots[sid]]) for sid in inputs}

    def replay(self, inputs: dict) -> dict:
        """Catch the sessions in ``inputs``, ``{sid: (u [K_i, du], y
        [K_i, dy])}`` with per-session lengths, up on their backlogs in
        one ``filter_replay`` per bucket chunk (and row block) under a
        ``[K, capacity]`` active mask; sessions not listed hold
        throughout. Equal to the sequential schedule in which tick t
        carries exactly the sessions with K_i > t. Returns ``{sid: (mean
        [K_i, dy], var [K_i, dy])}`` (numpy)."""
        if not inputs:
            raise ValueError("replay() needs at least one session input")
        self._require_replay()
        m = self.model
        staged = {}
        for sid, (u, y) in inputs.items():
            slot = self._slots[sid]  # KeyError on unknown sid
            u = np.asarray(u, dtype=m.np_dtype)
            y = np.asarray(y, dtype=m.np_dtype)
            if u.ndim != 2 or u.shape[1] != m.dim_u or u.shape[0] < 1:
                raise ValueError(
                    f"session {sid}: backlog u must be [K>=1, "
                    f"{m.dim_u}], got {u.shape}"
                )
            if y.shape != (u.shape[0], m.dim_y):
                raise ValueError(
                    f"session {sid}: backlog y must be [{u.shape[0]}, "
                    f"{m.dim_y}] to match u, got {y.shape}"
                )
            staged[slot] = (sid, u, y)
        k_total = max(u.shape[0] for _, u, _ in staged.values())
        u_full = np.zeros((self.capacity, k_total, m.dim_u), m.np_dtype)
        y_full = np.zeros((self.capacity, k_total, m.dim_y), m.np_dtype)
        act = np.zeros((k_total, self.capacity), np.bool_)
        for slot, (_, u, y) in staged.items():
            ki = u.shape[0]
            u_full[slot, :ki] = u
            y_full[slot, :ki] = y
            act[:ki, slot] = True
        means, vars_ = [], []
        for u_c, y_c, a_c, k_act in iter_replay_chunks(
                u_full, y_full, self._replay_buckets, active_full=act):
            eps = self._replay_draws(self._tick, u_c.shape[1], self.capacity)
            chunk_m, chunk_v = [], []
            with torch.no_grad():
                for b, (model, params, ops), (u_b, y_b, eps_b, a_b) in self._blocks(
                        self._dev(u_c), self._dev(y_c), draws=eps,
                        mask=torch.as_tensor(a_c, device=m.device)):
                    self._x[b], (mv, vv) = model.filter_replay(
                        params, ops, self._x[b], u_b, y_b, active=a_b, eps=eps_b)
                    chunk_m.append(mv)
                    chunk_v.append(vv)
            self._tick += k_act
            means.append(self._read_blocks(chunk_m)[:, :k_act])
            vars_.append(self._read_blocks(chunk_v)[:, :k_act])
        mean = means[0] if len(means) == 1 else np.concatenate(means, axis=1)
        var = vars_[0] if len(vars_) == 1 else np.concatenate(vars_, axis=1)
        return {sid: (mean[slot, :u.shape[0]], var[slot, :u.shape[0]])
                for slot, (sid, u, _) in staged.items()}

    def forecast(self, inputs: dict) -> dict:
        """Free-run the sessions in ``inputs``, ``{sid: u_future [H,
        du]}`` with one shared horizon H, without advancing any state.
        Returns ``{sid: (mean [H, dy], var [H, dy])}`` (numpy)."""
        if not inputs:
            raise ValueError("forecast() needs at least one session input")
        m = self.model
        for sid, u in inputs.items():
            shape = np.asarray(u).shape
            if len(shape) != 2 or shape[0] < 1:
                raise ValueError(
                    f"session {sid}: u_future must be [H >= 1, "
                    f"{m.dim_u}], got {shape}"
                )
        horizons = {np.asarray(u).shape[:1] for u in inputs.values()}
        if len(horizons) != 1:
            raise ValueError(
                f"all sessions must share one horizon, got {sorted(horizons)}"
            )
        (h,) = horizons.pop()
        u_full = np.zeros((self.capacity, h, m.dim_u), m.np_dtype)
        for sid, u in inputs.items():
            slot = self._slots[sid]
            u = np.asarray(u, dtype=m.np_dtype)
            if u.shape != (h, m.dim_u):
                raise ValueError(
                    f"session {sid}: u_future must be [{h}, {m.dim_u}], "
                    f"got {u.shape}"
                )
            u_full[slot] = u
        eps = self._draws(2**30 + self._tick, self._draw_shape((h,), self.capacity))
        means, vars_ = [], []
        with torch.no_grad():
            for b, (model, params, ops), (u_b, eps_b) in self._blocks(self._dev(u_full),
                                                                      draws=eps):
                mean, var = model.forecast(params, ops, self._x[b], u_b, eps=eps_b)
                means.append(mean)
                vars_.append(var)
        mean, var = self._read_blocks(means), self._read_blocks(vars_)
        return {sid: (mean[self._slots[sid]], var[self._slots[sid]]) for sid in inputs}

    # --- failover -------------------------------------------------------

    @property
    def state(self):
        """(ensemble [C, S, dx], tick, {sid: slot}, next_sid, base key
        uint32[2]): host values, serializable, the same for any mesh. The
        key rides along so a standby built with another seed resumes the
        primary's draws."""
        return (self._read_blocks(self._x), self._tick, dict(self._slots), self._next_sid,
                self._base_key.copy())

    def load_state(self, state) -> None:
        if len(state) == 4:  # pre-key snapshots: keep this seed's key
            (x, tick, slots, next_sid), key = state, None
        else:
            x, tick, slots, next_sid, key = state
        want = (self.capacity, self.model.samples, self.model.dim_x)
        if np.asarray(x).shape != want:
            raise ValueError(
                f"state ensemble shape {np.asarray(x).shape} != pool "
                f"shape {want}"
            )
        # coerce before validating and storing: a string-typed slot
        # ("3") would pass int()-based checks, miss the used-set and hand
        # its row to the next attach(); coercion can also collapse
        # aliased keys ("5" / "+5"), which is refused
        raw_len = len(dict(slots))
        slots = {int(s): int(v) for s, v in dict(slots).items()}
        if len(slots) != raw_len:
            raise ValueError("duplicate session ids in state table")
        bad = {s: v for s, v in slots.items() if not 0 <= int(v) < self.capacity}
        if bad:
            raise ValueError(
                f"state maps sessions to out-of-range slots {bad} "
                f"(capacity {self.capacity})"
            )
        if len(set(slots.values())) != len(slots):
            raise ValueError(
                f"state maps multiple sessions to one slot: {slots}"
            )
        # attach() hands out next_sid unconditionally: it must clear
        # every live sid, or a live session's mapping would be reissued
        if slots and int(next_sid) <= max(int(s) for s in slots):
            raise ValueError(
                f"state next_sid {int(next_sid)} collides with live "
                f"session ids (max {max(int(s) for s in slots)})"
            )
        self._base_key = self._restore_key(key, self._base_key)
        x = self._dev(np.asarray(x))
        self._x = [x[self._block_rows(b)].to(dev).clone() for b, dev in enumerate(self._devices)]
        self._tick = int(tick)
        self._slots = slots
        used = set(self._slots.values())
        self._free = [s for s in range(self.capacity - 1, -1, -1) if s not in used]
        self._next_sid = int(next_sid)


def _check_local_mesh(mesh, axis_name: str, capacity: int) -> None:
    """JAX's checks of a pool's mesh, and that it is a local one."""
    if not isinstance(mesh, LocalMesh):
        hint = ("a DeviceMesh spans a process group, one rank a device, and the pool is "
                "one process" if type(mesh).__name__ == "DeviceMesh"
                else f"got {type(mesh).__name__}")
        raise ValueError(f"FilterPool(mesh=) takes a parallel.local_mesh of this process's "
                         f"devices (ROADMAP A6.1b): {hint}")
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes: {mesh.axis_names})")
    n_shards = mesh.shape[axis_name]
    if int(capacity) % n_shards:
        raise ValueError(
            f"capacity {int(capacity)} must be a multiple of the "
            f"mesh {axis_name!r} axis size {n_shards}"
        )


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


class FilterBatcher(_CoalescingBatcher):
    """Coalescing front-end for a :class:`FilterPool`.

    A pool must be driven from one loop; a transport with one handler
    thread per connected estimator needs every pool operation on one
    thread and concurrent per-session operations coalesced into the
    pool's batched calls. Callers submit per-session operations from any
    thread and get Futures; one dispatcher thread drains the queue in
    FIFO order, groups adjacent compatible operations (same kind,
    distinct sessions, and for forecast one shared horizon) and serves
    each group in one pool call. All device work runs on that thread.

    >>> fb = FilterBatcher(FilterPool(model, params, capacity=32))
    >>> sid = fb.attach(u_prefix, y_prefix).result()
    >>> mean, var = fb.step(sid, u_prev, y_new).result()
    >>> fb.forecast(sid, u_future).result()    # (mean [H, dy], var)
    >>> fb.replay(sid, u_block, y_block).result()
    >>> fb.detach(sid).result(); fb.close()

    A second operation of a session already in the open group closes
    the group first, so a session never rides one dispatch twice and
    its operations never reorder. A session's result depends on the
    pool tick its group lands on, exactly as if the same groups were
    played into a bare pool. ``attach`` / ``detach`` / ``state`` /
    ``load_state`` / ``reload_params`` run as singleton items, between
    fleet dispatches. A failed item (unknown session) fails only its
    own future.
    """

    _GROUPABLE = ("step", "forecast", "replay")

    def __init__(self, pool, max_wait_ms: float = 2.0, queue_size: int = 1024):
        self.pool = pool
        super().__init__(max_wait_ms, queue_size, {
            "requests": 0, "dispatches": 0, "errors": 0,
            "grouped_ops": 0, "max_group_seen": 0, "wait_s": 0.0,
        }, "cbfssm-filterbatcher")

    # --- client side (any thread) ---------------------------------------

    def _submit(self, kind, sid, payload) -> Future:
        fut: Future = Future()
        self._enqueue((kind, sid, payload, fut, time.perf_counter()))
        return fut

    def attach(self, u_prefix, y_prefix) -> Future:
        """Future resolving to the new session id. Shape errors raise
        here (submit side), not in the future."""
        model = self.pool.model
        recog_len = int(model.config.recog_len)
        u = np.asarray(u_prefix, dtype=model.np_dtype)
        y = np.asarray(y_prefix, dtype=model.np_dtype)
        if u.shape != (recog_len, model.dim_u):
            raise ValueError(
                f"u_prefix must be [{recog_len}, {model.dim_u}] "
                f"(one session), got {u.shape}"
            )
        if y.shape != (recog_len, model.dim_y):
            raise ValueError(
                f"y_prefix must be [{recog_len}, {model.dim_y}] to match "
                f"u_prefix, got {y.shape}"
            )
        return self._submit("attach", None, (u, y))

    def detach(self, sid: int) -> Future:
        """Future resolving to None once the slot is released."""
        return self._submit("detach", int(sid), None)

    def step(self, sid: int, u_prev, y_new) -> Future:
        """Future resolving to this session's ``(mean [dy], var [dy])``;
        concurrent steps of other sessions may ride the same pool call."""
        model = self.pool.model
        u = np.asarray(u_prev, dtype=model.np_dtype)
        y = np.asarray(y_new, dtype=model.np_dtype)
        if u.shape != (model.dim_u,) or y.shape != (model.dim_y,):
            raise ValueError(
                f"expected u [{model.dim_u}] and y [{model.dim_y}], "
                f"got {u.shape} / {y.shape}"
            )
        return self._submit("step", int(sid), (u, y))

    def forecast(self, sid: int, u_future) -> Future:
        """Future resolving to ``(mean [H, dy], var [H, dy])`` without
        advancing state; coalesces with same-horizon forecasts."""
        model = self.pool.model
        u = np.asarray(u_future, dtype=model.np_dtype)
        if u.ndim != 2 or u.shape[1] != model.dim_u or u.shape[0] < 1:
            raise ValueError(
                f"u_future must be [H>=1, {model.dim_u}], got {u.shape}"
            )
        return self._submit("forecast", int(sid), u)

    def replay(self, sid: int, u_block, y_block) -> Future:
        """Future resolving to ``(mean [K, dy], var [K, dy])`` after a
        backlog catch-up; ragged replays of other sessions may share the
        pool call (its per-(tick, slot) mask)."""
        model = self.pool.model
        u = np.asarray(u_block, dtype=model.np_dtype)
        y = np.asarray(y_block, dtype=model.np_dtype)
        if u.ndim != 2 or u.shape[1] != model.dim_u or u.shape[0] < 1:
            raise ValueError(
                f"backlog u must be [K>=1, {model.dim_u}], got {u.shape}"
            )
        if y.shape != (u.shape[0], model.dim_y):
            raise ValueError(
                f"backlog y must be [{u.shape[0]}, {model.dim_y}] to "
                f"match u, got {y.shape}"
            )
        return self._submit("replay", int(sid), (u, y))

    def state(self) -> Future:
        """Future resolving to the pool's failover snapshot, taken
        between dispatches (never mid-tick)."""
        return self._submit("state", None, None)

    def load_state(self, state) -> Future:
        """Future resolving to None once the snapshot is restored."""
        return self._submit("load_state", None, state)

    def reload_params(self, params) -> Future:
        """Future resolving to None once the fleet serves the new
        checkpoint (sessions keep their state); the swap lands between
        fleet dispatches."""
        return self._submit("reload_params", None, params)

    def stats(self) -> dict:
        """requests, dispatches (pool calls incl. lifecycle items),
        errors, mean_group_size, max_group_seen, mean_wait_ms."""
        with self._lock:
            s = dict(self._stats)
        n, d = s.pop("grouped_ops"), s["dispatches"]
        wait = s.pop("wait_s")
        s["mean_group_size"] = n / d if d else 0.0
        s["mean_wait_ms"] = 1e3 * wait / n if n else 0.0
        return s

    # --- dispatcher thread ----------------------------------------------

    def _collect_cap(self) -> int:
        # a group cannot exceed the pool's capacity, and a longer sweep
        # would only delay the first item
        return self.pool.capacity

    def _flush(self, kind, group):
        """Serve one homogeneous group (distinct sids) in one pool call;
        an unknown sid fails only its own future."""
        live, inputs = [], {}
        for sid, payload, fut, t in group:
            if not fut.set_running_or_notify_cancel():
                continue
            if sid not in self.pool._slots:
                fut.set_exception(KeyError(f"unknown session {sid}"))
                with self._lock:
                    self._stats["errors"] += 1
                continue
            live.append((sid, fut, t))
            inputs[sid] = payload
        if not live:
            return
        t_dispatch = time.perf_counter()
        with self._lock:
            self._stats["dispatches"] += 1
            self._stats["grouped_ops"] += len(live)
            self._stats["max_group_seen"] = max(self._stats["max_group_seen"], len(live))
            self._stats["wait_s"] += sum(t_dispatch - t for *_, t in live)
        try:
            out = getattr(self.pool, kind)(inputs)
            for sid, fut, _t in live:
                fut.set_result(out[sid])
        except Exception as exc:
            failed = 0
            for _sid, fut, _t in live:
                if not fut.done():
                    fut.set_exception(exc)
                    failed += 1
            with self._lock:
                self._stats["errors"] += failed

    def _run_single(self, kind, sid, payload, fut, t):
        """A lifecycle or failover item on the dispatcher thread."""
        if not fut.set_running_or_notify_cancel():
            return
        with self._lock:
            self._stats["dispatches"] += 1
            self._stats["grouped_ops"] += 1
            # lifecycle items count in grouped_ops, so their wait
            # belongs in wait_s (mean_wait_ms)
            self._stats["wait_s"] += time.perf_counter() - t
        try:
            if kind == "attach":
                fut.set_result(self.pool.attach(*payload))
            elif kind == "detach":
                fut.set_result(self.pool.detach(sid))
            elif kind == "state":
                fut.set_result(self.pool.state)
            elif kind == "reload_params":
                fut.set_result(self.pool.reload_params(payload))
            else:  # load_state
                fut.set_result(self.pool.load_state(payload))
        except Exception as exc:
            fut.set_exception(exc)
            with self._lock:
                self._stats["errors"] += 1

    def _serve(self, batch) -> None:
        with self._lock:
            self._stats["requests"] += len(batch)
        # group_sids: the open group's sessions (a set, so a tick of
        # many sessions groups in linear time)
        group_kind, group, group_sids, horizon = None, [], set(), None
        for kind, sid, payload, fut, t in batch:
            if kind not in self._GROUPABLE:
                if group:
                    self._flush(group_kind, group)
                    group_kind, group, group_sids, horizon = None, [], set(), None
                self._run_single(kind, sid, payload, fut, t)
                continue
            h = payload.shape[0] if kind == "forecast" else None
            boundary = (
                kind != group_kind
                or sid in group_sids
                or (kind == "forecast" and h != horizon)
            )
            if group and boundary:
                self._flush(group_kind, group)
                group, group_sids = [], set()
            group_kind, horizon = kind, h
            group.append((sid, payload, fut, t))
            group_sids.add(sid)
        if group:
            self._flush(group_kind, group)
