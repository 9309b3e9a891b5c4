"""The port's system-identification data layer against ``cbfssm_tpu``:
the task loaders on fixtures staged under the real file names, the
``SystemIdDS`` datasets, ``OutputSummary``, ``DSManager``'s samplers and
options, the generators and both ``create_datasets`` modules. All of it
is numpy host code, so the arrays (and files) are compared byte for byte.
"""

import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io

from cbfssm_tpu import data as jdata
from cbfssm_tpu.data import generators as jgen
from cbfssm_tpu.data import system_id_tasks as jtasks
from cbfssm_tpu.data.ds_manager import DSManager as JaxDSManager
from cbfssm_tpu.outputs.summary import OutputSummary as JaxOutputSummary
from cbfssm_tpu_torch import data
from cbfssm_tpu_torch.data import generators, synthetic, system_id_tasks
from cbfssm_tpu_torch.data.ds_manager import DSManager
from cbfssm_tpu_torch.outputs import OutputSummary

ROOT = Path(__file__).resolve().parents[1]
TASK_FIELDS = ("train_in", "train_out", "test_in", "test_out")


def stage_sysid(d: Path, seed: int) -> Path:
    """The six raw files under their real names (the port's synthetic
    writer; both packages read the same files)."""
    synthetic.sysid_files(str(d), seed)
    return d


@pytest.fixture(scope="module")
def sysid_dir(tmp_path_factory):
    return stage_sysid(tmp_path_factory.mktemp("sysid"), 0)


def assert_tasks_equal(got, want):
    assert got.dt == want.dt
    for f in TASK_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert len(a) == len(b) > 0, f
        for x, y in zip(a, b):
            assert np.array_equal(x, y), f


@pytest.mark.parametrize("task", sorted(system_id_tasks.TASK_LOADERS))
def test_task_loaders_are_the_jax_loaders(sysid_dir, task):
    assert_tasks_equal(system_id_tasks.TASK_LOADERS[task](str(sysid_dir)),
                       jtasks.TASK_LOADERS[task](str(sysid_dir)))


def test_resample_task_is_the_jax_resample(sysid_dir):
    got = system_id_tasks.resample_task(system_id_tasks.load_drive(str(sysid_dir)), 1.5)
    want = jtasks.resample_task(jtasks.load_drive(str(sysid_dir)), 1.5)
    assert_tasks_equal(got, want)
    assert got.train_in[0].shape == (375, 1)


def test_validate_task_rejects_a_truncated_file(tmp_path):
    """A raw file shorter than its split point fails in the loader."""
    scipy.io.savemat(tmp_path / "actuator.mat", {"u": np.zeros((512, 1)), "p": np.zeros((512, 1))})
    for loader in (system_id_tasks.load_actuator, jtasks.load_actuator):
        with pytest.raises(ValueError, match="zero length"):
            loader(str(tmp_path))


@pytest.mark.parametrize("name,seq_len,stride", [("Sarcos", 250, 10), ("Actuator", 50, 1),
                                                 ("Furnace", 50, 1)])
def test_sysid_datasets_are_the_jax_arrays(sysid_dir, name, seq_len, stride):
    got = getattr(data, name)(seq_len, stride, data_dir=str(sysid_dir))
    want = getattr(jdata, name)(seq_len, stride, data_dir=str(sysid_dir))
    assert (got.dim_u, got.dim_y) == (want.dim_u, want.dim_y)
    for attr in (*TASK_FIELDS, "train_in_batch", "train_out_batch", "test_in_batch",
                 "test_out_batch"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
    for key in ("in", "out"):
        assert np.array_equal(got.mean[key], want.mean[key])
        assert np.array_equal(got.std[key], want.std[key])
    if name == "Sarcos":  # 60 x 10 training windows of 250 steps, 7 -> 7
        assert got.train_in_batch.shape == (600, 250, 7)


def test_sysid_dataset_rejects_wrong_channels(tmp_path):
    scipy.io.savemat(tmp_path / "actuator.mat", {"u": np.zeros((1024, 2)),
                                                 "p": np.zeros((1024, 1))})
    with pytest.raises(ValueError, match="needs 1"):
        data.Actuator(50, 1, data_dir=str(tmp_path))


class FakeOutputs:
    def __init__(self, rmse, nll):
        self.rmse = rmse
        self.last_calibration = {"nll": nll, "coverage": {0.5: 0.4, 0.95: 0.9 + nll / 100}}

    def get_last_rmse(self):
        return self.rmse


def test_output_summary_is_the_jax_summary(tmp_path):
    for cls, tag in ((OutputSummary, "port"), (JaxOutputSummary, "jax")):
        summary = cls(str(tmp_path / tag))
        for rmse, nll in ((0.5, 1.25), (0.75, 1.5), (0.625, 2.0)):
            summary.add_outputs(FakeOutputs(rmse, nll))
        summary.write_summary()
    text = (tmp_path / "port" / "summary.txt").read_text()
    assert text == (tmp_path / "jax" / "summary.txt").read_text()
    assert "Mean: 0.625000" in text and "coverage" in text


def test_sample_save_and_load_ds_are_the_jax_ones(tmp_path, capsys):
    """sample_ds + save_ds of the same rollout, then load_ds with its
    normalize / print_title / dtype options."""
    files = {}
    for dsm, gen, tag in ((DSManager, generators, "port"), (JaxDSManager, jgen, "jax")):
        rng = np.random.default_rng(5)
        sim = gen.RoboMoveDS(np.zeros(2), 0.0, 1e-5, 1e-4, rng=rng)
        u, x, y = dsm.sample_ds(sim, 200, gen.RoboMovePolicy(rng=rng))
        files[tag] = str(tmp_path / f"{tag}.mat")
        dsm.save_ds(files[tag], u, x, y, "RoboMove-test")
    for kw in ({}, {"normalize": True}, {"print_title": False, "dtype": np.float32}):
        got = DSManager.load_ds(files["port"], **kw)
        want = JaxDSManager.load_ds(files["jax"], **kw)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b), kw
    assert capsys.readouterr().out.count("Loaded Dataset RoboMove-test") == 4


def test_sample_ds_matrix_and_spring_generators_are_the_jax_ones():
    class ColumnSim:
        def __init__(self):
            self.x = np.zeros((3, 1))

        def get_state(self):
            return self.x.copy()

        def measure(self):
            return 2.0 * self.x[:2]

        def propagate(self, u):
            self.x = self.x + np.vstack([u, u, u])

    def policy(i, x):
        return np.asarray([[float(i)]])

    got = DSManager.sample_ds_matrix(ColumnSim(), 5, policy)
    want = JaxDSManager.sample_ds_matrix(ColumnSim(), 5, policy)
    assert all(np.array_equal(a, b) for a, b in zip(got, want, strict=True))
    outs = []
    for gen, dsm in ((generators, DSManager), (jgen, JaxDSManager)):
        a, b, c = gen.spring_nonlinear_system()
        rng = np.random.default_rng(2)
        sim = gen.SpringNonlinearDS(a, b, c, np.eye(3) * 1e-4, np.eye(1) * 1e-4,
                                    [1.0, 0.0, 0.0], rng=rng)
        outs.append(dsm.sample_ds(sim, 50, lambda ts, s: np.asarray([np.sin(ts / 5)])))
    assert all(np.array_equal(a, b) for a, b in zip(*outs, strict=True))


def load_script(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,flags", [
    ("create_robomove", ["--partial"]),
    ("create_robomove", []),
    ("create_spring_nonlinear", []),
])
def test_create_datasets_write_the_jax_files(tmp_path, monkeypatch, script, flags):
    """The port's ``python -m cbfssm_tpu_torch.create_datasets.<name>``
    and the repository's script write the same arrays for one seed."""
    port = importlib.import_module(f"cbfssm_tpu_torch.create_datasets.{script}")
    ref = load_script(ROOT / "create_datasets" / f"{script}.py", f"ref_{script}")
    for mod, tag in ((port, "port"), (ref, "jax")):
        out = str(tmp_path / f"{tag}.mat")
        monkeypatch.setattr(sys, "argv", [script, *flags, "--size", "300", "--seed", "3",
                                          "--out", out])
        mod.main()
    got, want = (scipy.io.loadmat(tmp_path / f"{t}.mat") for t in ("port", "jax"))
    for k in ("ds_u", "ds_x", "ds_y", "title"):
        assert np.array_equal(got[k], want[k]), k
    assert got["ds_u"].shape[0] == 300
