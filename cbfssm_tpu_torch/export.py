"""Exported artifacts: the port's deployment unit (port of
``cbfssm_tpu/export.py``).

A trained model is exported once to a directory of ``torch.export``
programs; a serving process loads the directory and runs it without the
model classes: the load side imports ``torch``, ``numpy``, the custom op
the programs call and nothing of :mod:`cbfssm_tpu_torch.models` or
:mod:`cbfssm_tpu_torch.serving`. The program is pinned: a later change
to the model code cannot change what an artifact computes.

On-disk layout of a predictor (one directory per artifact)::

    <path>/predictor.pt2   the torch.export program (torch.export.save)
    <path>/params.npz      flat parameter leaves p0..pN
    <path>/meta.json       shapes, dtypes, draws and the checksum manifest

and of a single-session filter: ``filter_init.pt2``, ``filter_step.pt2``,
``filter_forecast_{h}.pt2`` per exported horizon, ``filter_replay_{k}.pt2``
per replay bucket, ``arrays.npz`` (params ``p*`` and the filter
operators ``o*``, computed at export) and ``meta.json``.
:mod:`cbfssm_tpu_torch.export_pool` writes and loads the fleet pool.

Design:

- Each program is a non-strict ``torch.export.export`` of a plain
  function over flat tensors, traced under ``torch.no_grad``. Parameters
  enter as a flat tuple in :func:`~cbfssm_tpu_torch.serving.params_to_leaves`'
  order and layout (the JAX package's ``tree_leaves``), so ``params.npz``
  is the JAX package's file for the same params.
- Every ``gp_predict`` of a program is the custom op
  ``cbfssm_torch::gp_predict`` (:func:`~cbfssm_tpu_torch.ops.fused_predict.gp_predict_op`):
  on the card one launch of the CUDA kernel, on the CPU its plain version.
- A program draws nothing: its standard-normal draws are inputs, whose
  shapes ``meta.json`` lists in draw order (``noise_shapes``). The
  loaders draw them from ``torch.Generator``s seeded as the live
  predictors and filters seed theirs, so an artifact's reply equals the
  live one bitwise on the same device; ``noise=`` takes ready-made draws.
- A program is traced on one device and moved to the serving device at
  load (``torch.export.passes.move_to_device_pass``). ``platforms``
  (``cpu``, ``cuda``) lists the devices it may be loaded on. The
  loaders run on the card unless the caller passes ``device="cpu"``.
- On the card a predictor is compiled at load (:func:`_compile_program`,
  ``torch.compile`` with the persistent compile cache of
  :mod:`cbfssm_tpu_torch.utils.compile_cache`), as the JAX package jits
  its deserialized call. The filter programs stay uncompiled: they are
  held bitwise to the live, eager filters, in lockstep and in failover.

The meta keys are the JAX package's, with ``torch_version`` in place of
``jax_version``, ``platforms`` among cpu / cuda, ``noise_shapes`` added
and ``.pt2`` program files in the sha256 manifest.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import types
import typing

import numpy as np
import torch

from cbfssm_tpu_torch.config import check_precision
from cbfssm_tpu_torch.ops import fused_predict  # noqa: F401 (registers the programs' op)
from cbfssm_tpu_torch.predict_output import PredictOutput
from cbfssm_tpu_torch.streams import (iter_replay_chunks, key_seed, normal_draws,
                                      normalize_replay_ladder, seed_key)

_FIELDS = tuple(f.name for f in dataclasses.fields(PredictOutput))
_ARTIFACT = "predictor.pt2"
_PARAMS = "params.npz"
_META = "meta.json"
PLATFORMS = ("cpu", "cuda")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# Artifact-layout version, stamped into every meta.json and checked on
# load: a layout change fails with "format vX, loader expects vY —
# re-export" instead of an obscure load error. Artifacts without the
# stamp read as v0.
FORMAT_VERSION = 1


def _file_sha256(full):
    h = hashlib.sha256()
    with open(full, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest(path, names):
    """{filename: sha256} for exactly the files the exporter wrote (never
    a directory walk: a stray file in the target directory must not
    become load-bearing), so a loader detects a torn or corrupted copy."""
    return {name: _file_sha256(os.path.join(path, name)) for name in sorted(names)}


def _verify_checksums(path, meta):
    """Check meta's sha256 manifest (an artifact without one skips it)."""
    for name, want in (meta.get("sha256") or {}).items():
        full = os.path.join(path, name)
        if not os.path.isfile(full):
            raise RuntimeError(
                f"{path}: artifact file {name!r} is missing but listed in the meta's sha256 "
                "manifest — incomplete copy? re-copy or re-export")
        got = _file_sha256(full)
        if got != want:
            raise RuntimeError(
                f"{path}/{name}: checksum mismatch (expected {want[:12]}…, got {got[:12]}…) — "
                "artifact corrupted in transit? re-copy or re-export")


def _load_artifact_meta(path, meta_name, kind, hint, device):
    """Shared load guard of every artifact kind: read the meta and check
    its format version, kind, checksums, that ``device`` is one of its
    platforms and TF32. Returns (meta, the torch device)."""
    with open(os.path.join(path, meta_name)) as f:
        meta = json.load(f)
    version = meta.get("format_version", 0)
    if version != FORMAT_VERSION:
        raise RuntimeError(
            f"{path}: artifact format v{version}, this loader expects v{FORMAT_VERSION} — "
            "re-export with the current library"
            + (" (the artifact predates format stamping)" if version == 0 else ""))
    actual = meta.get("kind", "predictor")
    if actual != kind:
        raise ValueError(f"{path} is a {actual!r} artifact, not an exported {kind} ({hint})")
    if "torch_version" not in meta:
        raise RuntimeError(
            f"{path} was exported by the JAX package (jax {meta.get('jax_version')}); "
            "re-export it with `python -m cbfssm_tpu_torch export`")
    _verify_checksums(path, meta)
    device = torch.device(device)
    if device.type not in meta["platforms"]:
        raise RuntimeError(
            f"artifact was exported for {meta['platforms']}, but the requested device is "
            f"'{device.type}'")
    check_precision(_DTYPES[meta["dtype"]], device)
    return meta, device


def _artifact_base_key(meta):
    return np.asarray(meta["key_default"], dtype=np.dtype(meta["key_dtype"])).reshape(
        tuple(meta["key_shape"]))


def _platforms(platforms) -> list:
    plats = list(platforms)
    if not plats or any(p not in PLATFORMS for p in plats):
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, got {plats}")
    return plats


def _flatten(obj):
    """(tensor leaves, rebuild): the leaves of a tensor or of a (nested)
    tuple, list or dataclass of tensors, and a function that builds the
    same structure from an iterator over replacement leaves."""
    if isinstance(obj, torch.Tensor):
        return [obj], next
    if dataclasses.is_dataclass(obj) or isinstance(obj, (tuple, list)):
        items = ([getattr(obj, f.name) for f in dataclasses.fields(obj)]
                 if dataclasses.is_dataclass(obj) else list(obj))
        parts = [_flatten(o) for o in items]
        make = type(obj) if dataclasses.is_dataclass(obj) else (lambda *a, t=type(obj): t(a))
        return ([leaf for leaves, _ in parts for leaf in leaves],
                lambda it: make(*(rebuild(it) for _, rebuild in parts)))
    raise TypeError(f"cannot flatten {type(obj).__name__} into tensors")


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args):
    """A non-strict ``torch.export`` program of ``fn`` at ``args``."""
    with torch.no_grad():
        return torch.export.export(_Program(fn), tuple(args), strict=False)


def _load_program(path, name, device):
    """The program ``name`` of an artifact, moved to ``device``, as a
    callable module."""
    from torch.export.passes import move_to_device_pass

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # the pass writes the device into the graph's device arguments: with
        # its index, as the tensors report it, or a compile's metadata
        # checks ('cuda' against 'cuda:0') fail
        device = torch.device("cuda", torch.cuda.current_device())
    ep = torch.export.load(os.path.join(path, name))
    return move_to_device_pass(ep, str(device)).module()


# Inductor options of a compile at load: no on-device timing picks a
# kernel's configuration (Inductor's deterministic mode, which keeps the
# reductions' configurations to one, and no pointwise autotuning), so a
# program compiles to the same kernels, and answers the same bits, in
# every process, and a cold compile times no kernel configurations.
COMPILE_OPTIONS = {"deterministic": True, "triton.autotune_pointwise": False}


def _compile_program(module, example_args):
    """``module`` compiled by ``torch.compile`` (Inductor's default mode,
    the whole graph, static shapes, :data:`COMPILE_OPTIONS`), as JAX's
    ``jax.jit(exported.call)`` compiles a deserialized program. It
    enables the persistent compile cache first
    (:mod:`cbfssm_tpu_torch.utils.compile_cache`), and runs one call on
    ``example_args`` under ``torch.no_grad``, so a compile error raises
    here and the first request does not pay the compile.

    No CUDA graphs (``reduce-overhead``): the kernel launch counters do
    not count a replay. No ``max_autotune``: its Triton matmul templates
    take TF32. Nothing is caught: if the compile fails, the load fails;
    the uncompiled program is never run in its place."""
    from cbfssm_tpu_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    compiled = torch.compile(module, fullgraph=True, dynamic=False, options=COMPILE_OPTIONS)
    with torch.no_grad():
        compiled(*example_args)
    return compiled


def gp_predict_nodes(program) -> int:
    """The ``cbfssm_torch::gp_predict`` nodes of a loaded program (or of
    an ``ExportedProgram``): the kernel launches of one call."""
    op = torch.ops.cbfssm_torch.gp_predict.default
    return sum(1 for n in program.graph.nodes if n.op == "call_function" and n.target is op)


def _load_arrays(path, name, prefix, count, device):
    with np.load(os.path.join(path, name)) as arrays:
        return tuple(torch.as_tensor(arrays[f"{prefix}{i}"]).to(device) for i in range(count))


def _output_fields(model):
    """The served fields of ``model.predict`` from its return annotation:
    the PredictOutput fields, or None for a dict (its keys are read when
    the program is traced)."""
    declared = typing.get_type_hints(type(model).predict).get("return")
    if isinstance(declared, type) and issubclass(declared, PredictOutput):
        return _FIELDS
    if declared is dict:
        return None
    raise TypeError(
        f"{type(model).__name__}.predict returns "
        f"{getattr(declared, '__name__', repr(declared))} without a pred_mean field; "
        "exported predictors support CBFSSM/CBFSSMHALF/PRSSM (PredictOutput) and Voliro "
        "(dict)")


def save_exported_predictor(path, model, params, batch, seq_len, *, condition=False,
                            platforms=PLATFORMS, seed=0):
    """Export ``model.predict`` at one ``(batch, seq_len)`` shape to an
    artifact directory loadable by :class:`ExportedPredictor`.

    ``model.predict`` must return a ``PredictOutput`` (CBFSSM,
    CBFSSMHALF, PRSSM) or a dict with a ``pred_mean`` field (Voliro,
    whose fields export as they are); the fields are recorded in the
    meta. The model's draws become program inputs, with their shapes in
    ``noise_shapes``. ``platforms`` lists the devices the artifact may be
    loaded on; the trace runs on the model's device. Returns the meta.
    """
    from cbfssm_tpu_torch.serving import params_from_tensors, params_to_tensors

    plats = _platforms(platforms)
    fields = _output_fields(model)
    key = seed_key(seed)
    generator = torch.Generator(device=model.device).manual_seed(seed)
    noise, rebuild_noise = _flatten(model.draw_noise(generator, seq_len, batch))
    flat = tuple(params_to_tensors(params))
    kw = dict(dtype=model.dtype, device=model.device)
    u = torch.zeros((batch, seq_len, model.dim_u), **kw)
    y = torch.zeros((batch, seq_len, model.dim_y), **kw)
    traced = []

    def fn(flat_params, u, y, draws):
        p = params_from_tensors(params, flat_params)
        out = model.predict(p, u, y, condition=condition, noise=rebuild_noise(iter(draws)))
        out = dict(out) if isinstance(out, dict) else {f: getattr(out, f) for f in _FIELDS}
        traced[:] = list(out)
        return out

    ep = _export(fn, (flat, u, y, tuple(noise)))
    fields = fields or tuple(traced)
    if "pred_mean" not in fields:
        raise TypeError(f"{type(model).__name__}.predict returns a dict without a pred_mean "
                        f"field ({list(fields)})")
    os.makedirs(path, exist_ok=True)
    torch.export.save(ep, os.path.join(path, _ARTIFACT))
    np.savez(os.path.join(path, _PARAMS),
             **{f"p{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(flat)})
    meta = {
        "kind": "predictor",
        "model_class": type(model).__name__,
        "batch": int(batch),
        "seq_len": int(seq_len),
        "dim_u": int(model.dim_u),
        "dim_y": int(model.dim_y),
        "dtype": np.dtype(model.np_dtype).name,
        "condition": bool(condition),
        "n_params": len(flat),
        "key_shape": list(key.shape),
        "key_dtype": key.dtype.name,
        # the seed a call without one uses, as CompiledPredictor(seed=...)
        "key_default": key.tolist(),
        "requires_x64": model.dtype == torch.float64
        or any(t.dtype == torch.float64 for t in flat),
        "platforms": plats,
        "torch_version": torch.__version__,
        "format_version": FORMAT_VERSION,
        "output_fields": list(fields),
        "noise_shapes": [list(t.shape) for t in noise],
    }
    meta["sha256"] = _manifest(path, [_ARTIFACT, _PARAMS])
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedPredictor:
    """Serve a :func:`save_exported_predictor` artifact.

    Construction reads the three files and loads the program onto
    ``device`` (the card unless the caller passes ``"cpu"``); no model
    class is built or imported. A call checks the input shapes and
    returns the prediction dict of tensors on that device: the
    PredictOutput fields, or the model's own (Voliro);
    ``meta["output_fields"]`` says which.

    Draws: a call with ``seed`` (default: the export's seed) draws
    ``noise_shapes`` in order from ``torch.Generator(device).manual_seed(seed)``,
    as ``CompiledPredictor(..., seed=seed)`` does, so the replies are
    equal on one device; ``noise=`` takes ready-made draws instead (a
    tensor, a sequence of tensors in draw order, or the model's noise
    dataclass, e.g. ``RolloutNoise``).

    Compilation: on the card the program is compiled at load
    (:func:`_compile_program`, with the persistent compile cache), as the
    JAX package jits its deserialized call; ``compiled`` is the module a
    call runs, ``program`` the uncompiled one. A compile failure raises
    from the constructor. On the CPU the program runs uncompiled
    (``compiled`` is None), as a kernel wrapper takes its plain version
    there.

    >>> pred = ExportedPredictor(path)
    >>> out = pred(u, y)          # or pred(u, y, seed=s) / pred(u, y, noise=draws)
    >>> out["pred_mean"].shape    # [batch, seq_len, dim_y]
    """

    def __init__(self, path, device="cuda"):
        self.meta, self.device = _load_artifact_meta(
            path, _META, "predictor", "use ExportedFilter", device)
        self.dtype = _DTYPES[self.meta["dtype"]]
        self.seed = key_seed(_artifact_base_key(self.meta))
        self.program = _load_program(path, _ARTIFACT, self.device)
        # on the device once: host leaves would be copied on every call
        self._params = _load_arrays(path, _PARAMS, "p", self.meta["n_params"], self.device)
        self.compiled = (_compile_program(self.program, self._zero_args())
                         if self.device.type == "cuda" else None)

    def _zero_args(self) -> tuple:
        """The program's arguments with zero inputs and draws."""
        m = self.meta
        kw = dict(dtype=self.dtype, device=self.device)
        return (self._params, torch.zeros((m["batch"], m["seq_len"], m["dim_u"]), **kw),
                torch.zeros((m["batch"], m["seq_len"], m["dim_y"]), **kw),
                tuple(torch.zeros(tuple(s), **kw) for s in m["noise_shapes"]))

    def _draw_noise(self, seed: int) -> list:
        """The draws of a call with ``seed``, in draw order."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        return [torch.randn(tuple(s), generator=g, dtype=self.dtype, device=self.device)
                for s in self.meta["noise_shapes"]]

    def __call__(self, u, y, seed: int | None = None, noise=None):
        m = self.meta
        kw = dict(dtype=self.dtype, device=self.device)
        u = torch.as_tensor(u, **kw)
        y = torch.as_tensor(y, **kw)
        want_u = (m["batch"], m["seq_len"], m["dim_u"])
        want_y = (m["batch"], m["seq_len"], m["dim_y"])
        if tuple(u.shape) != want_u:
            raise ValueError(f"exported for u {want_u}, got {tuple(u.shape)}")
        if tuple(y.shape) != want_y:
            raise ValueError(f"exported for y {want_y}, got {tuple(y.shape)}")
        check_precision(self.dtype, self.device)
        if noise is None:
            draws = self._draw_noise(self.seed if seed is None else seed)
        else:
            draws = [torch.as_tensor(a, **kw) for a in _flatten(noise)[0]]
            got = [list(a.shape) for a in draws]
            if got != m["noise_shapes"]:
                raise ValueError(f"noise must have the shapes {m['noise_shapes']}, got {got}")
        run = self.program if self.compiled is None else self.compiled
        with torch.no_grad():
            return run(self._params, u, y, tuple(draws))


def load_exported_predictor(path, device="cuda"):
    """Alias of :class:`ExportedPredictor` for symmetric naming."""
    return ExportedPredictor(path, device)


# --- online-filter artifacts ------------------------------------------

_F_INIT = "filter_init.pt2"
_F_STEP = "filter_step.pt2"
_F_FORECAST = "filter_forecast_{h}.pt2"
_F_REPLAY = "filter_replay_{k}.pt2"
_F_META = "meta.json"
_F_STATE = "arrays.npz"
_FILTER_FILES = {"init": _F_INIT, "step": _F_STEP, "forecast": _F_FORECAST,
                 "replay": _F_REPLAY}


def _validate_streaming_model(model, buckets, hint):
    """Shared check of the streaming kinds before anything is written."""
    for attr in ("filter_ops", "filter_init", "filter_step", "forecast"):
        if not hasattr(model, attr):
            raise TypeError(f"{type(model).__name__} has no streaming interface ({attr}); "
                            f"{hint}")
    if buckets and not hasattr(model, "filter_replay"):
        raise TypeError(f"{type(model).__name__} has no filter_replay; export without "
                        "replay_buckets")


def _draw_shape(draws: int, lead, b: int, samples: int) -> tuple:
    """The ``eps=`` shape of ``filter_step`` (``lead`` empty), of
    ``forecast`` (``lead = (H,)``) or ``filter_replay`` (``(K,)``) at
    batch ``b``: ``lead + (b, S, 1)``, with a ``draws`` axis before ``b``
    for a model whose step takes more than one draw (Voliro: 2)."""
    return tuple(lead) + ((draws,) if draws > 1 else ()) + (b, samples, 1)


def _export_streaming(model, params, batch, init_batch, horizons, buckets, pooled):
    """Trace the streaming programs of ``model`` at ``batch`` rows
    (``init_batch`` for the recognition warmup). ``pooled``: the replay
    mask is per (tick, row) ``[K, batch]``, else per tick ``[K]``.
    Returns ({role or (role, length): program}, params leaves, operator
    leaves, the draw shape of one step)."""
    from cbfssm_tpu_torch.serving import params_from_tensors, params_to_tensors

    with torch.no_grad():
        ops = model.filter_ops(params)
    p_flat = tuple(params_to_tensors(params))
    o_leaves, rebuild_ops = _flatten(ops)
    o_flat = tuple(t.contiguous() for t in o_leaves)
    kw = dict(dtype=model.dtype, device=model.device)
    draws = getattr(model, "FILTER_DRAWS", 1)
    r, s = int(model.config.recog_len), model.samples
    step_shape = _draw_shape(draws, (), batch, s)

    def unpack(pf, of):
        return params_from_tensors(params, pf), rebuild_ops(iter(of))

    def init_fn(pf, u, y):
        return model.filter_init(params_from_tensors(params, pf), u, y)

    def step_fn(pf, of, x, u, y, eps):
        x_new, (mean, var) = model.filter_step(*unpack(pf, of), x, u, y, eps=eps)
        return {"x": x_new, "mean": mean, "var": var}

    def forecast_fn(pf, of, x, u, eps):
        mean, var = model.forecast(*unpack(pf, of), x, u, eps=eps)
        return {"mean": mean, "var": var}

    def replay_fn(pf, of, x, u, y, active, eps):
        x_new, (mean, var) = model.filter_replay(*unpack(pf, of), x, u, y, active=active,
                                                 eps=eps)
        return {"x": x_new, "mean": mean, "var": var}

    def zeros(*shape):
        return torch.zeros(shape, **kw)

    x = zeros(batch, s, model.dim_x)
    programs = {
        "init": _export(init_fn, (p_flat, zeros(init_batch, r, model.dim_u),
                                  zeros(init_batch, r, model.dim_y))),
        "step": _export(step_fn, (p_flat, o_flat, x, zeros(batch, model.dim_u),
                                  zeros(batch, model.dim_y), zeros(*step_shape))),
    }
    for h in horizons:
        programs[("forecast", h)] = _export(forecast_fn, (
            p_flat, o_flat, x, zeros(batch, h, model.dim_u),
            zeros(*_draw_shape(draws, (h,), batch, s))))
    for k in buckets:
        active = torch.ones((k, batch) if pooled else (k,), dtype=torch.bool,
                            device=model.device)
        programs[("replay", k)] = _export(replay_fn, (
            p_flat, o_flat, x, zeros(batch, k, model.dim_u), zeros(batch, k, model.dim_y),
            active, zeros(*_draw_shape(draws, (k,), batch, s))))
    return programs, p_flat, o_flat, step_shape


def _write_streaming(path, kind, model, programs, p_flat, o_flat, step_shape, horizons,
                     buckets, plats, seed, files, extra):
    """Write the programs (named by ``files``), ``arrays.npz`` and the
    meta of a streaming artifact; returns the meta."""
    names = []
    os.makedirs(path, exist_ok=True)
    for role, ep in programs.items():
        name = (files[role] if isinstance(role, str)
                else files[role[0]].format(h=role[1], k=role[1]))
        torch.export.save(ep, os.path.join(path, name))
        names.append(name)
    np.savez(os.path.join(path, _F_STATE),
             **{f"p{i}": t.detach().cpu().numpy() for i, t in enumerate(p_flat)},
             **{f"o{i}": t.detach().cpu().numpy() for i, t in enumerate(o_flat)})
    key = seed_key(seed)
    meta = {
        "kind": kind,
        "model_class": type(model).__name__,
        "recog_len": int(model.config.recog_len),
        "samples": int(model.samples),
        "dim_x": int(model.dim_x),
        "dim_u": int(model.dim_u),
        "dim_y": int(model.dim_y),
        "dtype": np.dtype(model.np_dtype).name,
        "n_params": len(p_flat),
        "n_ops": len(o_flat),
        "horizons": [int(h) for h in horizons],
        "replay_buckets": list(buckets),
        "key_shape": list(key.shape),
        "key_dtype": key.dtype.name,
        "key_default": key.tolist(),
        "requires_x64": model.dtype == torch.float64
        or any(t.dtype == torch.float64 for t in p_flat + o_flat),
        "platforms": plats,
        "torch_version": torch.__version__,
        "format_version": FORMAT_VERSION,
        # the draws of one step; a forecast or replay of length L draws
        # L of them, stacked on a leading axis
        "noise_shapes": [list(step_shape)],
        **extra,
    }
    meta["sha256"] = _manifest(path, names + [_F_STATE])
    with open(os.path.join(path, _F_META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def save_exported_filter(path, model, params, batch=1, *, horizons=(), replay_buckets=(),
                         platforms=PLATFORMS, seed=0):
    """Export the streaming-filter interface (CBFSSMHALF, Voliro:
    ``filter_init`` / ``filter_step`` / ``forecast`` / ``filter_replay``)
    at ``batch`` streams to an artifact directory loadable by
    :class:`ExportedFilter`.

    The filter operators (``filter_ops``: the GP factorization) are
    computed here and stored as arrays. ``horizons`` lists the forecast
    lengths to export and ``replay_buckets`` the replay chunk lengths
    (:meth:`ExportedFilter.replay` chunks a backlog over them as
    ``StreamingFilter.replay`` does). Everything is checked and traced
    before the first file is written. Returns the meta.
    """
    _validate_streaming_model(model, replay_buckets,
                              "exported filters support CBFSSMHALF and Voliro")
    buckets = list(normalize_replay_ladder(replay_buckets or None))
    horizons = [int(h) for h in horizons]
    plats = _platforms(platforms)
    programs, p_flat, o_flat, step_shape = _export_streaming(
        model, params, batch, batch, horizons, buckets, pooled=False)
    return _write_streaming(path, "filter", model, programs, p_flat, o_flat, step_shape,
                            horizons, buckets, plats, seed, _FILTER_FILES,
                            {"batch": int(batch)})


class _ArtifactModel:
    """The stand-in for a streaming model that the filter loaders (and
    :class:`~cbfssm_tpu_torch.serving.FilterPool`'s host logic under
    :class:`~cbfssm_tpu_torch.export_pool.ExportedFilterPool`) read:
    dims, dtype, device and ``config.recog_len`` from the meta, and
    ``filter_init`` / ``filter_step`` / ``forecast`` / ``filter_replay``
    with the model's signatures, each calling its loaded program. A
    horizon or replay length that was not exported raises a
    ``ValueError``. ``model_class`` is the exporting class's name."""

    def __init__(self, path, meta, device, files):
        self.model_class = meta["model_class"]
        self.np_dtype = np.dtype(meta["dtype"])
        self.dtype = _DTYPES[meta["dtype"]]
        self.device = device
        self.dim_u, self.dim_y = int(meta["dim_u"]), int(meta["dim_y"])
        self.dim_x, self.samples = int(meta["dim_x"]), int(meta["samples"])
        step_shape = meta["noise_shapes"][0]
        self.FILTER_DRAWS = step_shape[0] if len(step_shape) == 4 else 1
        self.config = types.SimpleNamespace(recog_len=int(meta["recog_len"]))
        self._init = _load_program(path, files["init"], device)
        self._step = _load_program(path, files["step"], device)
        self._forecasts = {int(h): _load_program(path, files["forecast"].format(h=int(h)),
                                                 device) for h in meta["horizons"]}
        self._replays = {int(k): _load_program(path, files["replay"].format(k=int(k)), device)
                         for k in meta["replay_buckets"]}

    def programs(self) -> dict:
        """Every loaded program by role: ``init``, ``step``,
        ``forecast_{h}``, ``replay_{k}``."""
        return {"init": self._init, "step": self._step,
                **{f"forecast_{h}": p for h, p in self._forecasts.items()},
                **{f"replay_{k}": p for k, p in self._replays.items()}}

    def filter_init(self, params, u_prefix, y_prefix):
        check_precision(self.dtype, self.device)
        return self._init(params, u_prefix, y_prefix)

    def filter_step(self, params, ops, x, u_prev, y_new, eps):
        check_precision(self.dtype, self.device)
        out = self._step(params, ops, x, u_prev, y_new, eps)
        return out["x"], (out["mean"], out["var"])

    def forecast(self, params, ops, x, u_future, eps):
        h = u_future.shape[1]
        if h not in self._forecasts:
            raise ValueError(f"horizon {h} not exported (available: {sorted(self._forecasts)}); "
                             "re-export with it in `horizons`")
        check_precision(self.dtype, self.device)
        out = self._forecasts[h](params, ops, x, u_future, eps)
        return out["mean"], out["var"]

    def filter_replay(self, params, ops, x, u_block, y_block, active, eps):
        k = u_block.shape[1]
        if k not in self._replays:
            raise ValueError(f"no replay program of length {k} in this artifact (buckets: "
                             f"{sorted(self._replays)}); re-export with replay_buckets "
                             "covering the backlog")
        check_precision(self.dtype, self.device)
        out = self._replays[k](params, ops, x, u_block, y_block, active, eps)
        return out["x"], (out["mean"], out["var"])


def _load_streaming(path, meta, device, files):
    """(stand-in model, params leaves, operator leaves) of a filter or
    pool artifact, all on ``device``."""
    model = _ArtifactModel(path, meta, device, files)
    params = _load_arrays(path, _F_STATE, "p", meta["n_params"], device)
    ops = _load_arrays(path, _F_STATE, "o", meta["n_ops"], device)
    return model, params, ops


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


class ExportedFilter:
    """Serve a :func:`save_exported_filter` artifact with the
    ``StreamingFilter`` host API (``start`` / ``update`` / ``replay`` /
    ``forecast`` / ``state`` / ``load_state``), without the model classes
    or the serving stack.

    Update ``t`` draws from ``fold_seed(key_seed(base key), t)``, a
    forecast at counter ``t`` from ``2**30 + t`` (:meth:`_draws`), and a
    replay step the draws of the update it stands for: the stream of
    ``StreamingFilter``, so the two are equal bitwise on one device, and
    their snapshots (ensemble, counter, base key) restore into each
    other.
    """

    def __init__(self, path, device="cuda"):
        self.meta, device = _load_artifact_meta(path, _F_META, "filter",
                                                "use ExportedPredictor", device)
        self.model, self.params, self._ops = _load_streaming(path, self.meta, device,
                                                             _FILTER_FILES)
        self.batch = int(self.meta["batch"])
        self._replay_buckets = tuple(sorted(self.model._replays))
        self._base_key = _artifact_base_key(self.meta)
        self._x = None
        self._t = 0

    # --- draws ----------------------------------------------------------

    def _draw_shape(self, lead, b: int):
        return _draw_shape(self.model.FILTER_DRAWS, lead, b, self.model.samples)

    def _draws(self, index: int, shape):
        return normal_draws(self._base_key, index, shape, self.model.dtype, self.model.device)

    def _dev(self, a):
        return torch.as_tensor(a, dtype=self.model.dtype, device=self.model.device)

    # --- state (the StreamingFilter contract) ----------------------------

    @property
    def state(self):
        """(ensemble [B, S, dx] host array or None, counter, base key):
        the key rides along, so a standby exported with another seed
        resumes the primary's draws."""
        return (None if self._x is None else _host(self._x), self._t, self._base_key.copy())

    def load_state(self, state) -> None:
        if len(state) == 2:  # pre-key snapshots keep the export's key
            (x, t), key = state, None
        else:
            x, t, key = state
        if x is not None:
            m = self.model
            x = self._dev(x)
            want = (self.batch, m.samples, m.dim_x)
            if tuple(x.shape) != want:
                raise ValueError(f"ensemble must be {want} for this filter, got "
                                 f"{tuple(x.shape)}")
        if key is not None:
            key = np.asarray(key)
            cur = self._base_key
            if (key.shape, key.dtype) != (cur.shape, cur.dtype):
                raise ValueError(f"snapshot key has shape/dtype {(key.shape, key.dtype)}, "
                                 f"expected {(cur.shape, cur.dtype)}")
            self._base_key = key.copy()
        self._x = x
        self._t = int(t)

    def _require_started(self):
        if self._x is None:
            raise RuntimeError("call start(u_prefix, y_prefix) first")

    # --- the programs -----------------------------------------------------

    def start(self, u_prefix, y_prefix) -> None:
        m = self.model
        u = np.asarray(u_prefix, dtype=m.np_dtype)
        y = np.asarray(y_prefix, dtype=m.np_dtype)
        want = (self.batch, m.config.recog_len)
        if u.shape != want + (m.dim_u,):
            raise ValueError(f"exported for prefix {want + (m.dim_u,)}, got u {u.shape}")
        if y.shape != want + (m.dim_y,):
            raise ValueError(f"y_prefix must be {want + (m.dim_y,)}, got {y.shape}")
        with torch.no_grad():
            self._x = m.filter_init(self.params, self._dev(u), self._dev(y))
        self._t = 0

    def update(self, u_prev, y_new):
        """One conditioned transition; returns filtered (mean [B, dy],
        var [B, dy]) tensors on the artifact's device."""
        self._require_started()
        m = self.model
        u = np.asarray(u_prev, dtype=m.np_dtype)
        y = np.asarray(y_new, dtype=m.np_dtype)
        if u.shape != (self.batch, m.dim_u) or y.shape != (self.batch, m.dim_y):
            raise ValueError(
                f"update expects u [{self.batch}, {m.dim_u}] and y [{self.batch}, "
                f"{m.dim_y}], got {u.shape} / {y.shape}")
        eps = self._draws(self._t, self._draw_shape((), self.batch))
        with torch.no_grad():
            self._x, (mean, var) = m.filter_step(self.params, self._ops, self._x,
                                                 self._dev(u), self._dev(y), eps=eps)
        self._t += 1
        return mean, var

    def replay(self, u_block, y_block):
        """Catch up on a K-step backlog over the exported replay buckets
        (full chunks of the largest, the rest padded to the smallest that
        holds it), equal to K :meth:`update` calls. Returns host (mean
        [B, K, dy], var [B, K, dy])."""
        self._require_started()
        if not self._replay_buckets:
            raise ValueError("no replay programs in this artifact; re-export with "
                             "save_exported_filter(..., replay_buckets=(...))")
        m = self.model
        u = np.asarray(u_block, dtype=m.np_dtype)
        y = np.asarray(y_block, dtype=m.np_dtype)
        if u.ndim != 3 or u.shape[0] != self.batch or u.shape[2] != m.dim_u:
            raise ValueError(f"u_block must be [{self.batch}, K, {m.dim_u}], got {u.shape}")
        k_total = u.shape[1]
        if y.shape != (self.batch, k_total, m.dim_y):
            raise ValueError(f"y_block must be [{self.batch}, {k_total}, {m.dim_y}] to match "
                             f"u_block, got {y.shape}")
        means, vars_ = [], []
        for u_c, y_c, active, k_act in iter_replay_chunks(u, y, self._replay_buckets):
            shape = self._draw_shape((), self.batch)
            eps = torch.stack([self._draws(self._t + i, shape) for i in range(u_c.shape[1])])
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
        """Free-run over ``u_future`` [B, H, du] (H an exported horizon)
        without advancing the state; (mean, var) [B, H, dy] tensors."""
        self._require_started()
        m = self.model
        u = np.asarray(u_future, dtype=m.np_dtype)
        if u.ndim != 3 or u.shape[0] != self.batch or u.shape[2] != m.dim_u:
            raise ValueError(f"u_future must be [{self.batch}, H, {m.dim_u}], got {u.shape}")
        eps = self._draws(2**30 + self._t, self._draw_shape((u.shape[1],), self.batch))
        with torch.no_grad():
            return m.forecast(self.params, self._ops, self._x, self._dev(u), eps=eps)


def __getattr__(name):
    # the pool artifact lives in export_pool, whose loader subclasses
    # serving.FilterPool: importing it here would put the serving stack
    # into every predictor or filter load
    if name in ("save_exported_pool", "ExportedFilterPool"):
        from cbfssm_tpu_torch import export_pool

        return getattr(export_pool, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
