"""The port's evaluation layer and RoboMove run script (CPU).

- ``outputs/calibration.py`` equals the JAX package's, array for array;
- ``Outputs`` writes the artifact set after training, with a trainer
  and from ``best.ckpt`` alone;
- on the same params and rollout noise, its artifacts equal those of
  the JAX package's ``Outputs``;
- ``run_robomove.main(..., device="cpu")`` runs both curriculum phases
  end to end on a synthetic ``robomove.mat`` with the ``FAST`` overrides
  of tests/test_run_drivers_e2e.py.
"""

import os

import jax
import numpy as np
import pytest
import scipy.io
import torch

from cbfssm_tpu.data import DSManager
from cbfssm_tpu.models import CBFSSM as JaxCBFSSM
from cbfssm_tpu.outputs import Outputs as JaxOutputs
from cbfssm_tpu.outputs import calibration as jax_cal
from cbfssm_tpu_torch import run_robomove
from cbfssm_tpu_torch.convert import cbfssm_params_from_numpy
from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.outputs import Outputs
from cbfssm_tpu_torch.outputs import calibration as cal
from cbfssm_tpu_torch.training import Trainer
from tests.test_run_drivers_e2e import FAST
from tests.test_torch_cbfssm import jax_noise, params_numpy
from tests.test_trainer import SmokeDS, smoke_config

ARTIFACTS = ["training_loss.pdf", "predict_train.pdf", "predict_train.mat", "predict_test.pdf",
             "predict_test.mat", "mse.txt", "calibration.txt", "var_dump.txt"]


def predictions(seed):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(40, 2))
    var = rng.uniform(0.1, 2.0, size=(40, 2))
    return mean, var, mean + rng.normal(size=(40, 2)) * np.sqrt(var)


@pytest.mark.parametrize("level", [0.5, 0.9, 0.95, 0.99])
def test_z_score_equals_jax(level):
    assert cal.z_score(level) == jax_cal.z_score(level)


def test_calibration_functions_equal_jax():
    mean, var, y = predictions(0)
    np.testing.assert_array_equal(cal.gaussian_nll(mean, var, y), jax_cal.gaussian_nll(mean, var, y))
    parts = [cal.summarize(*predictions(s)) for s in range(3)]
    assert parts == [jax_cal.summarize(*predictions(s)) for s in range(3)]
    assert cal.accumulate(parts) == jax_cal.accumulate(parts)
    assert cal.format_report(cal.accumulate(parts)) == jax_cal.format_report(cal.accumulate(parts))
    assert cal.LEVELS == jax_cal.LEVELS
    with pytest.raises(ValueError, match="level"):
        cal.z_score(1.0)
    with pytest.raises(ValueError, match="no experiments"):
        cal.accumulate([])


def test_outputs_artifacts_with_and_without_trainer(tmp_path):
    ds = SmokeDS()
    model = CBFSSM(smoke_config(), device="cpu")
    out_dir = str(tmp_path / "out")
    trainer = Trainer(model, out_dir)
    trainer.train(ds, epochs=2)

    outputs = Outputs(out_dir)
    outputs.set_ds(ds)
    outputs.set_model(model, out_dir)
    outputs.set_trainer(trainer)
    outputs.create_all()
    for name in ARTIFACTS:
        assert os.path.isfile(os.path.join(out_dir, name)), name
    rmse = outputs.get_last_rmse()
    assert rmse is not None and np.isfinite(rmse)
    with open(os.path.join(out_dir, "mse.txt")) as f:
        content = f.read()
    assert content.startswith("MSE:") and "RMSE:" in content
    assert outputs.last_calibration["n_points"] == ds.test_out.size
    with open(os.path.join(out_dir, "var_dump.txt")) as f:
        assert f.read().startswith("process noise:")

    # a fresh Outputs without a trainer restores best.ckpt from disk
    again = Outputs(str(tmp_path / "again"))
    again.set_ds(ds)
    again.set_model(model, out_dir)
    again.create_all()
    assert again.get_last_rmse() == rmse
    assert not os.path.isfile(os.path.join(str(tmp_path / "again"), "training_loss.pdf"))


def test_outputs_match_jax_on_the_same_predictions(tmp_path, monkeypatch):
    """Both packages' Outputs on the same params and the same rollout
    noise (the JAX draws for ``PRNGKey(seed)``, handed to the port's
    predict as ``noise=``): the .mat arrays agree at rtol 1e-7, and
    mse.txt, calibration.txt and var_dump.txt are the same text. Two
    test experiments, so the per-experiment MSE and calibration
    accumulation run."""
    ds = SmokeDS()
    ds.test_in = ds.test_in.reshape(2, -1, ds.test_in.shape[-1])
    ds.test_out = ds.test_out.reshape(2, -1, ds.test_out.shape[-1])
    jm, pm = JaxCBFSSM(smoke_config()), CBFSSM(smoke_config(), device="cpu")
    jparams = jm.init(jax.random.PRNGKey(3))
    pparams = cbfssm_params_from_numpy(params_numpy(jparams), device="cpu")
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jo, po = JaxOutputs(dirs["jax"]), Outputs(dirs["port"])

    def port_predict(u, y, condition=False):
        noise = jax_noise(pm, jax.random.PRNGKey(po.seed), u.shape[1], u.shape[0])
        with torch.inference_mode():
            out = pm.predict(po.params, u, y, condition=condition, noise=noise)
        return out.pred_mean.numpy(), out.pred_var.numpy()

    monkeypatch.setattr(po, "_predict", port_predict)
    for outputs, model, params, out_dir in ((jo, jm, jparams, dirs["jax"]),
                                            (po, pm, pparams, dirs["port"])):
        outputs.set_ds(ds)
        outputs.set_model(model, out_dir)
        outputs.create_all(params=params)
    for name in ("predict_train.mat", "predict_test.mat"):
        want = scipy.io.loadmat(os.path.join(dirs["jax"], name))
        got = scipy.io.loadmat(os.path.join(dirs["port"], name))
        for key in ("mean", "std", "gt"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-7, atol=1e-12,
                                       err_msg=f"{name} {key}")
    for name in ("mse.txt", "calibration.txt", "var_dump.txt"):
        with open(os.path.join(dirs["jax"], name)) as f_want, \
                open(os.path.join(dirs["port"], name)) as f_got:
            assert f_got.read() == f_want.read(), name
    np.testing.assert_allclose(po.get_last_rmse(), jo.get_last_rmse(), rtol=1e-7)
    got, want = po.last_calibration, jo.last_calibration
    assert got["n_points"] == want["n_points"] == ds.test_out.size
    assert got["coverage"] == want["coverage"]
    for key in ("nll", "ece", "sde_rms"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-7, err_msg=key)


def test_outputs_without_params_raises(tmp_path):
    outputs = Outputs(str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="set_model"):
        outputs.create_all()
    outputs.set_ds(SmokeDS())
    outputs.set_model(CBFSSM(smoke_config(), device="cpu"), str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no trained parameters"):
        outputs.create_all()


def test_run_robomove_e2e_on_cpu(tmp_path):
    rng = np.random.default_rng(0)
    data_dir = str(tmp_path) + "/"
    n = 30000
    DSManager.save_ds(data_dir + "robomove.mat", rng.normal(size=(n, 2)),
                      rng.normal(size=(n, 3)), rng.normal(size=(n, 2)), "robomove")
    root = str(tmp_path / "out")
    run_robomove.main(root=root, epochs=1, data_dir=data_dir,
                      config_overrides=dict(FAST, recog_len=10), seq_len=50, seq_stride=5000,
                      device="cpu")
    for name in ARTIFACTS + ["robomove_train.pdf", "robomove_test.pdf", "model.ckpt",
                             "best.ckpt"]:
        assert os.path.exists(os.path.join(root, name)), name
    with open(os.path.join(root, "mse.txt")) as f:
        assert np.isfinite(float(f.read().split("RMSE: ")[1]))
