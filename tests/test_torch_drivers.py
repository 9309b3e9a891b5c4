"""The port's run drivers end to end on the CPU: each new driver's
``main()`` with ``device="cpu"`` at the tiny sizes of
tests/test_run_drivers_e2e.py (``FAST``) for one epoch, on fixtures
staged under the real file names, and its artifacts; and the
system-identification drivers with ``vmap_seeds=True`` (the seeds as one
lane-batched program), which write the serial loop's layout."""

import importlib
import os

import numpy as np
import pytest

from cbfssm_tpu_torch import run_sarcos, run_smallscale, run_spring, run_voliro
from cbfssm_tpu_torch.data import DSManager, synthetic
from tests.test_run_drivers_e2e import FAST
from tests.test_torch_lanes import one_thread  # noqa: F401 (autouse)
from tests.test_torch_sysid import stage_sysid


@pytest.fixture(scope="module")
def sysid_dir(tmp_path_factory):
    d = stage_sysid(tmp_path_factory.mktemp("sysid"), 1)
    rng = np.random.default_rng(2)
    DSManager.save_ds(str(d / "spring_nonlinear.mat"), rng.normal(size=(10000, 1)),
                      rng.normal(size=(10000, 3)), rng.normal(size=(10000, 3)),
                      "spring_nonlinear.mat")
    return str(d) + "/"


def assert_artifacts(out, names):
    for f in names:
        assert os.path.getsize(os.path.join(out, f)) > 0, f


def rmse(out):
    value = float(open(os.path.join(out, "mse.txt")).read().split("RMSE: ")[1])
    assert np.isfinite(value)
    return value


def test_run_voliro_main(tmp_path):
    synthetic.stage_all(str(tmp_path))
    root = str(tmp_path / "out")
    outputs = run_voliro.main(root=root, epochs=1, data_dir=str(tmp_path) + "/",
                              config_overrides={"samples": 2, "ind_pnt_num": 5,
                                                "batch_size": 4},
                              seq_len=16, seq_stride=500, device="cpu")
    assert_artifacts(root, ["voliro_forces.pdf", "voliro_forces.mat", "var_dump.txt",
                            "training_loss.pdf", "metrics.jsonl", "best.ckpt", "model.ckpt"])
    assert np.isfinite(outputs.trainer.train_all).all()


def test_run_sarcos_main(sysid_dir, tmp_path):
    root = str(tmp_path / "out")
    summary = run_sarcos.main(root=root, iterations=1, epochs=1, data_dir=sysid_dir,
                              config_overrides=FAST, seq_len=30, seq_stride=300, device="cpu")
    assert_artifacts(root, ["mse.txt", "summary.txt", "var_dump.txt", "predict_test.pdf",
                            "calibration.txt"])
    assert summary.rmse_all == pytest.approx([rmse(root)], abs=1e-6)  # mse.txt has 6 digits


def test_run_spring_main_two_iterations(sysid_dir, tmp_path):
    root = str(tmp_path / "out")
    summary = run_spring.main(root=root, iterations=2, train_iterations=1, data_dir=sysid_dir,
                              config_overrides=FAST, seq_len=20, seq_stride=100, device="cpu")
    for it in range(2):
        assert_artifacts(f"{root}/run_{it}", ["mse.txt", "metrics.jsonl", "training_loss.pdf"])
    want = [rmse(f"{root}/run_{it}") for it in range(2)]
    assert summary.rmse_all == pytest.approx(want, abs=1e-6)
    assert "RMSE" in open(root + "/summary.txt").read()


def test_run_smallscale_main(sysid_dir, tmp_path):
    root = str(tmp_path / "out")
    run_smallscale.main(task_list=[0], root=root, iterations=1, train_iterations=1,
                        data_dir=sysid_dir, config_overrides=FAST, seq_len=20, seq_stride=25,
                        device="cpu")
    out = root + "/actuator"
    assert_artifacts(out, ["mse.txt", "summary.txt", "var_dump.txt", "predict_test.pdf",
                           "training_loss.pdf"])
    rmse(out)


VMAP_RUNS = {
    "run_sarcos": (dict(epochs=1, seq_len=30, seq_stride=300), ""),
    "run_spring": (dict(train_iterations=1, seq_len=20, seq_stride=100), ""),
    "run_smallscale": (dict(task_list=[0], train_iterations=1, seq_len=20, seq_stride=25),
                       "/actuator"),
}


@pytest.mark.parametrize("driver", ["run_sarcos", "run_spring", "run_smallscale"])
def test_vmap_seeds_runs(driver, sysid_dir, tmp_path):
    """``vmap_seeds=True`` trains the iterations' seeds as one
    lane-batched program and writes the serial loop's layout: run_i/
    with each seed's artifacts, and summary.txt over the seeds."""
    mod = importlib.import_module(f"cbfssm_tpu_torch.{driver}")
    kwargs, sub = VMAP_RUNS[driver]
    root = str(tmp_path / "out")
    mod.main(root=root, iterations=2, data_dir=sysid_dir, config_overrides=FAST,
             vmap_seeds=True, device="cpu", **kwargs)
    out = root + sub
    want = []
    for it in range(2):
        assert_artifacts(f"{out}/run_{it}", ["mse.txt", "var_dump.txt", "predict_test.pdf",
                                             "calibration.txt", "training_loss.pdf"])
        want.append(rmse(f"{out}/run_{it}"))
    assert_artifacts(out, ["best.ckpt", "model.ckpt", "best_seeds.ckpt", "model_seeds.ckpt"])
    text = open(out + "/summary.txt").read()
    assert "RMSE" in text
    for value in want:
        assert "  %f\n" % value in text


def test_drivers_keep_the_reference_configs():
    """The dicts of run/*.py, key for key."""
    from scripts.driver_util import load_driver

    for mod, script in ((run_voliro, "run_voliro.py"), (run_sarcos, "run_sarcos.py"),
                        (run_spring, "run_spring.py")):
        ref = load_driver(script).model_config
        assert set(mod.model_config) == set(ref), script
        for k, v in ref.items():
            if k != "ds":
                np.testing.assert_array_equal(mod.model_config[k], v, err_msg=f"{script} {k}")
    ref = load_driver("run_smallscale.py")
    for task in range(5):
        got, want = run_smallscale.model_config(task), ref.model_config(task)
        assert got["ds"].__name__ == want["ds"].__name__
        for k in want:
            if k != "ds":
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"task {task} {k}")
