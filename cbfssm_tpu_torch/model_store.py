"""Self-describing model directories: rebuild a trained model from disk
(port of ``cbfssm_tpu/model_store.py``).

Every trainer of the port (:class:`~cbfssm_tpu_torch.training.Trainer`,
``MultiSeedTrainer``, ``SweepTrainer``) writes ``model_meta.json`` next
to its checkpoints: the model class, the full normalized config and the
seed. This module rebuilds ``(model, params)`` from the directory
alone::

    model, params = load_trained_model(model_dir)                 # best.ckpt
    model, params = load_trained_model(model_dir, "model.ckpt")   # last
    model, params = load_trained_model(model_dir, device="cpu")

That is what ``python -m cbfssm_tpu_torch eval`` and ``serve`` stand on.

The JSON is the JAX package's, key for key: the two ``ModelConfig``
dataclasses have the same fields, so one config gives one
``model_meta.json`` in either package, and the port rebuilds the config
of a directory the JAX package wrote. The checkpoints are not shared
(``torch.save`` files here, orbax there).

- The dataset class of ``config.ds`` is not rebuilt: models read only
  ``dim_u`` / ``dim_y`` from it, so the snapshot keeps those two ints
  and the class name, and :func:`build_model` passes a stub.
- numpy arrays round-trip through a tagged JSON encoding with their
  dtype; tuples come back as lists.
- Entries of ``config.extra`` that JSON cannot hold are dropped and
  named in ``dropped_keys``: the snapshot is written from inside the
  trainers' ``__init__`` and must never break training.
- There is no x64 switch to flip in PyTorch: :func:`meta_requires_x64`
  only reads the meta.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

MODEL_META = "model_meta.json"


# --- value encoding ----------------------------------------------------


def _encode(value):
    """JSON-encodable form of a config value (tagged ndarray support)."""
    if isinstance(value, np.ndarray):
        return {"__ndarray__": value.tolist(), "dtype": str(value.dtype)}
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _encode(v) for k, v in value.items()}
    return value


def _decode(value):
    if isinstance(value, dict):
        if "__ndarray__" in value:
            return np.asarray(value["__ndarray__"], dtype=np.dtype(value["dtype"]))
        return {k: _decode(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v) for v in value]
    return value


def _json_safe(value) -> bool:
    """True when ``value`` survives a json round trip."""
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False


# --- save --------------------------------------------------------------


def _unwrap(model):
    """An adapter model (``SweptModel``'s ``template``, ``ParticleParallel``'s
    full-config ``model``) snapshots its inner model: the class and
    config that :func:`load_trained_model` must rebuild."""
    for attr in ("template", "model"):
        inner = getattr(model, attr, None)
        if inner is not None and hasattr(inner, "config") and hasattr(inner, "dim_u"):
            return inner
    return model


def save_model_meta(model_dir: str, model, seed: int = 0) -> dict:
    """Write ``model_meta.json`` describing ``model`` into ``model_dir``
    and return it. Safe to call again (atomic overwrite); a folded sweep
    winner and the dataset recipe of an earlier snapshot of the same
    model class are carried forward."""
    model = _unwrap(model)
    cfg = model.config
    config = {}
    dropped = []
    for f in dataclasses.fields(cfg):
        if f.name in ("ds", "extra"):
            continue
        value = getattr(cfg, f.name)
        if f.name == "dtype":
            # every dtype spelling the model accepts snapshots to one name
            value = np.dtype(value).name
        enc = _encode(value)
        if _json_safe(enc):
            config[f.name] = enc
        else:
            dropped.append(f.name)
    extra = {}
    for k, v in (cfg.extra or {}).items():
        enc = _encode(v)
        if _json_safe(enc):
            extra[k] = enc
        else:
            dropped.append(f"extra.{k}")
    ds = cfg.ds
    meta = {
        "format": 1,
        "model_class": type(model).__name__,
        "dim_u": int(model.dim_u),
        "dim_y": int(model.dim_y),
        "seed": int(seed),
        "config": config,
        "extra": extra,
        "dropped_keys": dropped,
        "ds_name": None if ds is None else getattr(ds, "__name__", type(ds).__name__),
    }
    os.makedirs(model_dir, exist_ok=True)
    try:
        prior = load_model_meta(model_dir)
    except Exception:
        prior = None
    same_class = prior is not None and prior.get("model_class") == meta["model_class"]
    # the dataset recipe `eval <dir>` depends on survives a re-stamp;
    # the next train() stamps the dataset it used
    if same_class and prior.get("dataset"):
        meta["dataset"] = prior["dataset"]
    if same_class and prior.get("config_updates"):
        updates = prior["config_updates"]
        pre_fold = updates.get("prior", {})
        kept = {}
        for k, v in updates.get("values", {}).items():
            target = "config" if k in meta["config"] else "extra"
            # a fold is carried forward only where this model was built
            # with the pre-fold base value; an explicit new value wins
            if meta[target].get(k) == pre_fold.get(k, meta[target].get(k)):
                meta[target][k] = v
                kept[k] = v
        if kept:
            meta["config_updates"] = {**updates, "values": kept}
    _write_meta(model_dir, meta)
    return meta


def _write_meta(model_dir: str, meta: dict) -> None:
    path = os.path.join(model_dir, MODEL_META)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, path)


def fold_config_updates(model_dir: str, updates: dict, note: str | None = None) -> dict:
    """Fold concrete config values into ``model_meta.json`` (the
    ``SweepTrainer``'s winning grid point, whose params ``best.ckpt``
    holds), recording them under ``config_updates`` with the pre-fold
    values. Returns the updated metadata."""
    meta = load_model_meta(model_dir)
    applied = {}
    pre_fold = {}
    for k, v in updates.items():
        enc = _encode(v)
        if not _json_safe(enc):
            continue
        target = "config" if k in meta["config"] else "extra"
        pre_fold[k] = meta[target].get(k)
        meta[target][k] = enc
        applied[k] = enc
    meta["config_updates"] = {"values": applied, "prior": pre_fold, "note": note}
    _write_meta(model_dir, meta)
    return meta


def record_dataset(model_dir: str, ds) -> None:
    """Stamp ``model_meta.json`` with the dataset's recipe (class name
    and windowing; every dataset class takes ``(seq_len, seq_stride,
    data_dir=None)``), so ``eval <dir>`` rebuilds the evaluation dataset
    from disk alone."""
    meta = load_model_meta(model_dir)
    meta["dataset"] = {
        "name": type(ds).__name__,
        "seq_len": int(ds.seq_len),
        "seq_stride": int(ds.seq_stride),
    }
    _write_meta(model_dir, meta)


# --- load --------------------------------------------------------------


def load_model_meta(model_dir: str) -> dict:
    path = os.path.join(model_dir, MODEL_META)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found — the directory was not written by this "
            "framework's Trainer (or predates model snapshots); "
            "rebuild the model from its config instead"
        )
    with open(path) as f:
        return json.load(f)


def meta_requires_x64(meta: dict) -> bool:
    """True when the snapshot describes a 64-bit model."""
    dt = meta.get("config", {}).get("dtype")
    if dt is None:
        return False
    try:
        return np.dtype(dt).itemsize == 8
    except TypeError:
        return False


def build_model(meta: dict, device="cuda"):
    """The model described by ``meta`` on ``device`` (no checkpoint
    I/O)."""
    from cbfssm_tpu_torch import models

    cls = getattr(models, meta["model_class"], None)
    if cls is None:
        raise ValueError(
            f"unknown model class {meta['model_class']!r} (not in cbfssm_tpu_torch.models)"
        )

    class _StubDS:  # models read only dim_u / dim_y
        dim_u = int(meta["dim_u"])
        dim_y = int(meta["dim_y"])

    _StubDS.__name__ = str(meta.get("ds_name") or "StubDS")
    config = {k: _decode(v) for k, v in meta["config"].items()}
    config.update({k: _decode(v) for k, v in meta.get("extra", {}).items()})
    config["ds"] = _StubDS
    return cls(config, device=device)


def restore_params(model, path: str, seed: int = 0):
    """The params saved in the checkpoint at ``path`` (a trainer's tree:
    ``{"params": [tensor, ...], ...}`` in ``params.tensors()`` order),
    rebuilt in ``model``'s structure on its device. The one restore of a
    checkpoint without a trainer: ``load_trained_model`` and
    ``Outputs`` both use it."""
    import torch

    from cbfssm_tpu_torch.training import checkpoint

    template = model.init(torch.Generator(device=model.device).manual_seed(int(seed)))
    saved = checkpoint.restore(path, map_location=model.device)["params"]
    leaves = template.tensors()
    if len(saved) != len(leaves):
        raise ValueError(f"{path} holds {len(saved)} params, the model {len(leaves)}")
    return template.with_tensors([s.to(t.dtype) for s, t in zip(saved, leaves)])


def load_trained_model(model_dir: str, checkpoint_name: str | None = None, device="cuda"):
    """Rebuild ``(model, params)`` on ``device`` from a trainer-written
    directory. ``checkpoint_name`` defaults to the best checkpoint
    (``best.ckpt``); pass ``"model.ckpt"`` for the final state. Pending
    background writes of the process's trainers to this directory land
    first."""
    from cbfssm_tpu_torch.training import checkpoint

    meta = load_model_meta(model_dir)
    model = build_model(meta, device=device)
    name = checkpoint.BEST if checkpoint_name is None else checkpoint_name
    path = os.path.join(model_dir, name)
    checkpoint.shared_saver().flush(model_dir)
    if not checkpoint.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return model, restore_params(model, path, seed=meta.get("seed", 0))
