"""Self-describing model directories of the port
(``cbfssm_tpu_torch/model_store.py``) against the JAX package's
``cbfssm_tpu/model_store.py`` (CPU, float64).

- For one config (numpy ``var_x``, a float64 dtype in any spelling, an
  extra entry JSON cannot hold) the two packages write equal
  ``model_meta.json`` files, and the port rebuilds the config of a
  JAX-written one.
- The counterparts of tests/test_model_store.py's non-export cases on
  the port's trainers: the stamped directory, ``load_trained_model``
  bitwise equal to ``Trainer.restore`` (best and last), the rebuilt
  model predicting identically under one generator seed, multi-seed and
  sweep directories, the fold's carry-forward rules, adapter models, the
  canonical dtype name, and the errors.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from cbfssm_tpu import model_store as jax_store
from cbfssm_tpu.models import CBFSSM as JaxCBFSSM
from cbfssm_tpu.models import CBFSSMHALF as JaxCBFSSMHALF
from cbfssm_tpu_torch import model_store
from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF
from cbfssm_tpu_torch.outputs import Outputs
from cbfssm_tpu_torch.training import (MultiSeedTrainer, SweepTrainer, SweptModel, Trainer,
                                        checkpoint)
from tests.test_other_models import half_config
from tests.test_torch_lanes import one_thread  # noqa: F401 (autouse)
from tests.test_trainer import SmokeDS, smoke_config


def port_model(cfg=None):
    return CBFSSM(smoke_config() if cfg is None else cfg, device="cpu")


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    """One short training run shared by the read-side tests."""
    path = str(tmp_path_factory.mktemp("store") / "m")
    model = port_model()
    trainer = Trainer(model, path, seed=4)
    trainer.train(SmokeDS(), epochs=2)
    return path, model, trainer


def load_json(path):
    with open(os.path.join(path, model_store.MODEL_META)) as f:
        return json.load(f)


@pytest.mark.parametrize("kind, dtype", [("cbfssm", "float64"), ("cbfssm", np.float64),
                                         ("half", np.dtype("float64"))])
def test_meta_json_equals_jax(tmp_path, kind, dtype):
    """One config, one model_meta.json: equal dicts after json.load, the
    same dropped keys."""
    cfg = smoke_config() if kind == "cbfssm" else half_config("rnn")
    cfg.update(dtype=dtype, weird=object(), kept=np.arange(3.0))
    jax_cls, port_cls = (JaxCBFSSM, CBFSSM) if kind == "cbfssm" else (JaxCBFSSMHALF, CBFSSMHALF)
    jax_store.save_model_meta(str(tmp_path / "jax"), jax_cls(cfg), seed=3)
    meta = model_store.save_model_meta(str(tmp_path / "port"), port_cls(cfg, device="cpu"),
                                       seed=3)
    want, got = load_json(str(tmp_path / "jax")), load_json(str(tmp_path / "port"))
    assert got == want
    assert got["dropped_keys"] == ["extra.weird"] == meta["dropped_keys"]
    assert got["config"]["dtype"] == "float64"


def test_jax_written_meta_rebuilds_config(tmp_path):
    """A directory the JAX package stamped rebuilds the same config in
    the port: every field, the dims and the extra entries."""
    cfg = dict(smoke_config(), k_factor=7.5, extra_key=[1, 2])
    jm = JaxCBFSSM(cfg)
    jax_store.save_model_meta(str(tmp_path), jm, seed=2)
    rebuilt = model_store.build_model(model_store.load_model_meta(str(tmp_path)), device="cpu")
    assert type(rebuilt) is CBFSSM and rebuilt.device.type == "cpu"
    assert (rebuilt.dim_u, rebuilt.dim_y) == (SmokeDS.dim_u, SmokeDS.dim_y)
    assert rebuilt.config.ds.__name__ == "SmokeDS"
    for f in dataclasses.fields(jm.config):
        if f.name in ("ds", "extra"):
            continue
        want, got = getattr(jm.config, f.name), getattr(rebuilt.config, f.name)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f.name
    assert rebuilt.config.extra == {"extra_key": [1, 2]}


def test_trainer_writes_meta(trained_dir):
    path, model, _ = trained_dir
    meta = load_json(path)
    assert meta["model_class"] == "CBFSSM"
    assert meta["dim_u"] == SmokeDS.dim_u and meta["dim_y"] == SmokeDS.dim_y
    assert meta["seed"] == 4
    assert meta["ds_name"] == "SmokeDS"
    cfg = smoke_config()
    decoded = model_store._decode(meta["config"]["var_x"])
    np.testing.assert_array_equal(decoded, cfg["var_x"])
    assert decoded.dtype == cfg["var_x"].dtype
    assert meta["config"]["dtype"] == "float64"
    assert meta["dropped_keys"] == []
    assert meta["dataset"] == {"name": "SmokeDS", "seq_len": 12, "seq_stride": 4}


def test_load_trained_model_matches_restore(trained_dir):
    """best and last: bitwise the params Trainer.restore gives, on the
    device asked for, as leaves that need no grad."""
    path, _, trainer = trained_dir
    for name in (checkpoint.BEST, checkpoint.LAST):
        model, params = model_store.load_trained_model(
            path, None if name == checkpoint.BEST else name, device="cpu")
        want = trainer.restore(name)
        for a, b in zip(params.tensors(), want.tensors(), strict=True):
            assert torch.equal(a, b.detach()) and a.dtype == b.dtype
            assert a.device.type == "cpu" and not a.requires_grad


def test_outputs_restore_is_load_trained_model(trained_dir, tmp_path):
    """Outputs without a trainer and load_trained_model restore
    best.ckpt through one code path: the same params, bit for bit."""
    path, model, _ = trained_dir
    outputs = Outputs(str(tmp_path))
    outputs.set_model(model, path)
    _, params = model_store.load_trained_model(path, device="cpu")
    for a, b in zip(outputs._restore_params().tensors(), params.tensors(), strict=True):
        assert torch.equal(a, b)


def test_rebuilt_model_predicts_identically(trained_dir, rng):
    path, original, _ = trained_dir
    rebuilt, params = model_store.load_trained_model(path, device="cpu")
    assert type(rebuilt) is type(original)
    u = torch.as_tensor(rng.normal(size=(2, 8, SmokeDS.dim_u)))
    y = torch.as_tensor(rng.normal(size=(2, 8, SmokeDS.dim_y)))
    a = original.predict(params, u, y, torch.Generator().manual_seed(11))
    b = rebuilt.predict(params, u, y, torch.Generator().manual_seed(11))
    assert torch.equal(a.pred_mean, b.pred_mean) and torch.equal(a.mse, b.mse)


def test_load_waits_for_pending_writes(tmp_path):
    """A checkpoint still queued on the background writer lands before
    load_trained_model reads the directory."""
    model = port_model()
    out = str(tmp_path)
    model_store.save_model_meta(out, model)
    params = model.init(torch.Generator().manual_seed(5))
    checkpoint.shared_saver().save(os.path.join(out, checkpoint.BEST),
                                   {"params": params.tensors(), "opt_state": {}})
    _, loaded = model_store.load_trained_model(out, device="cpu")
    for a, b in zip(loaded.tensors(), params.tensors(), strict=True):
        assert torch.equal(a, b)


def test_encode_decode_roundtrip():
    values = {
        "arr": np.asarray([1.5, 2.5], dtype=np.float32),
        "nested": [np.asarray([1, 2]), "s", 3, {"k": np.float64(2.0)}],
        "plain": (1.0, 2.0),
    }
    enc = model_store._encode(values)
    json.dumps(enc)  # must be JSON-clean
    assert enc == jax_store._encode(values)
    dec = model_store._decode(enc)
    np.testing.assert_array_equal(dec["arr"], values["arr"])
    assert dec["arr"].dtype == np.float32
    np.testing.assert_array_equal(dec["nested"][0], values["nested"][0])
    assert dec["nested"][3]["k"] == 2.0
    assert dec["plain"] == [1.0, 2.0]


def test_unserializable_extra_dropped_not_fatal(tmp_path):
    cfg = smoke_config()
    cfg["weird"] = object()  # lands in config.extra
    meta = model_store.save_model_meta(str(tmp_path), port_model(cfg))
    assert "extra.weird" in meta["dropped_keys"]
    assert "weird" not in meta["extra"]
    rebuilt = model_store.build_model(model_store.load_model_meta(str(tmp_path)), device="cpu")
    assert type(rebuilt) is CBFSSM


def test_missing_meta_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="model_meta.json"):
        model_store.load_model_meta(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="model_meta.json"):
        model_store.load_trained_model(str(tmp_path), device="cpu")


def test_missing_checkpoint_raises(tmp_path):
    model_store.save_model_meta(str(tmp_path), port_model())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        model_store.load_trained_model(str(tmp_path), device="cpu")


def test_unknown_model_class_raises(tmp_path):
    meta = model_store.save_model_meta(str(tmp_path), port_model())
    meta["model_class"] = "NoSuchModel"
    with pytest.raises(ValueError, match="unknown model class"):
        model_store.build_model(meta, device="cpu")


def test_multiseed_dir_is_loadable(tmp_path):
    """MultiSeedTrainer directories carry the snapshot too: best.ckpt is
    the winning seed's unstacked tree."""
    out = str(tmp_path / "ms")
    trainer = MultiSeedTrainer(port_model(), out, n_seeds=2, seed=7)
    trainer.train(SmokeDS(), epochs=2)
    model, params = model_store.load_trained_model(out, device="cpu")
    assert type(model) is CBFSSM
    expected = trainer._single_tree(trainer.best_seed(), best=True)["params"]
    for a, b in zip(params.tensors(), expected, strict=True):
        assert torch.equal(a, b.detach())
    meta = model_store.load_model_meta(out)
    assert meta["model_class"] == "CBFSSM" and meta["seed"] == 7
    assert meta["dataset"]["name"] == "SmokeDS"


def test_sweep_dir_folds_winning_point(tmp_path):
    """SweepTrainer snapshots the inner template (not the SweptModel
    adapter) and folds the winning grid point into the meta after
    training, so the rebuilt model is the winning configuration."""
    out = str(tmp_path / "sw")
    sweep = {"k_factor": np.asarray([1.0, 50.0, 200.0])}
    trainer = SweepTrainer(CBFSSM, smoke_config(), sweep, out, device="cpu")
    trainer.train(SmokeDS(), epochs=2)
    best = trainer.best_config()
    meta = model_store.load_model_meta(out)
    assert meta["model_class"] == "CBFSSM"
    assert meta["config"]["k_factor"] == best["k_factor"]
    assert meta["config_updates"]["values"] == {"k_factor": best["k_factor"]}
    assert meta["config_updates"]["note"] == "sweep best point (by train loss)"
    model, params = model_store.load_trained_model(out, device="cpu")
    assert float(model.config.k_factor) == best["k_factor"]
    u = torch.zeros((1, 8, SmokeDS.dim_u), dtype=torch.float64)
    y = torch.zeros((1, 8, SmokeDS.dim_y), dtype=torch.float64)
    pred = model.predict(params, u, y, torch.Generator().manual_seed(0))
    assert torch.isfinite(pred.pred_mean).all()


def test_reinstantiation_preserves_folded_winner(tmp_path):
    """Reopening a directory whose snapshot holds a folded sweep winner
    keeps the winning values; a different model class repurposes it."""
    model = port_model()
    out = str(tmp_path)
    model_store.save_model_meta(out, model)
    model_store.fold_config_updates(out, {"k_factor": 123.0}, note="win")
    model_store.save_model_meta(out, model, seed=9)
    meta = model_store.load_model_meta(out)
    assert meta["config"]["k_factor"] == 123.0
    assert meta["config_updates"]["values"] == {"k_factor": 123.0}
    assert meta["seed"] == 9
    model_store.save_model_meta(out, CBFSSMHALF(half_config("rnn"), device="cpu"))
    meta = model_store.load_model_meta(out)
    assert meta["model_class"] == "CBFSSMHALF"
    assert "k_factor" not in meta.get("config_updates", {}).get("values", {})


def test_explicit_new_config_supersedes_stale_fold(tmp_path):
    """A model built with a different value for a folded key supersedes
    the stale winner; keys still at the pre-fold base keep the fold."""
    cfg = smoke_config()
    base_k = cfg["k_factor"]
    out = str(tmp_path)
    model_store.save_model_meta(out, port_model(cfg))
    model_store.fold_config_updates(out, {"k_factor": 123.0, "zeta_pos": 9.0}, note="win")
    cfg2 = dict(smoke_config(), k_factor=base_k + 1.0)
    model_store.save_model_meta(out, port_model(cfg2))
    meta = model_store.load_model_meta(out)
    assert meta["config"]["k_factor"] == base_k + 1.0
    assert meta["config"]["zeta_pos"] == 9.0
    assert meta["config_updates"]["values"] == {"zeta_pos": 9.0}


def test_adapter_models_snapshot_inner_model(tmp_path):
    """A SweptModel snapshots its template: a trainer on the adapter
    still writes a loadable directory."""
    swept = SweptModel(CBFSSM, smoke_config(), ("k_factor",), device="cpu")
    meta = model_store.save_model_meta(str(tmp_path), swept, seed=3)
    assert meta["model_class"] == "CBFSSM"
    assert meta["config"]["samples"] == smoke_config()["samples"]
    assert type(model_store.build_model(meta, device="cpu")) is CBFSSM


def test_dtype_spelling_canonicalized(tmp_path):
    """Any dtype spelling snapshots to the canonical name."""
    cfg = dict(smoke_config(), dtype=np.float64)  # a type object, not the string
    model = port_model(cfg)
    assert model.dtype == torch.float64
    meta = model_store.save_model_meta(str(tmp_path), model)
    assert meta["config"]["dtype"] == "float64"
    assert model_store.meta_requires_x64(meta)
    assert not model_store.meta_requires_x64({"config": {"dtype": "float32"}})
    assert not model_store.meta_requires_x64({"config": {}})
    with pytest.raises(ValueError, match="dtype must be"):
        port_model(dict(smoke_config(), dtype="int32"))


def test_dataset_recipe_survives_meta_restamp(trained_dir, tmp_path):
    """A trainer re-instantiated on a trained directory (retrain /
    eval-only flows) keeps the dataset recipe eval depends on."""
    path, model, _ = trained_dir
    recipe = model_store.load_model_meta(path)["dataset"]
    Trainer(model, path, seed=4)  # __init__ re-stamps model_meta.json
    assert model_store.load_model_meta(path)["dataset"] == recipe
