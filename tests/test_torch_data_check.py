"""Raw-data validation of the port (``cbfssm_tpu_torch/data/check.py``)
against the JAX package's ``cbfssm_tpu/data/check.py``: on the fixtures
of tests/test_data_check.py (the packaged DSManager files, the
system-identification tasks, a corrupt file, Voliro logs), both give the
same ``CheckResult`` list, and ``reproduce --check-data`` of both CLIs
the same exit codes."""

import dataclasses

import numpy as np
import pytest
import scipy.io

from cbfssm_tpu.__main__ import main as jax_cli
from cbfssm_tpu.data.check import check_experiment as jax_check
from cbfssm_tpu_torch.__main__ import main as port_cli
from cbfssm_tpu_torch.data import DSManager, synthetic
from cbfssm_tpu_torch.data.check import CheckResult, check_experiment, report


def same_results(experiment, data_dir=None):
    """The port's results, after checking they equal the JAX package's."""
    got = check_experiment(experiment, data_dir)
    want = jax_check(experiment, data_dir)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert all(isinstance(r, CheckResult) for r in got)
    return got


@pytest.mark.parametrize("experiment", ["spring", "robomove"])
def test_packaged_generated_datasets_pass(experiment):
    results = same_results(experiment)
    assert results and all(r.ok for r in results), results


def test_smallscale_reports_per_file_status(tmp_path, rng, capsys):
    d = str(tmp_path) + "/"
    scipy.io.savemat(d + "actuator.mat",
                     {"u": rng.normal(size=(1024, 1)), "p": rng.normal(size=(1024, 1))})
    by_file = {r.file: r for r in same_results("smallscale", d)}
    assert by_file["actuator.mat"].ok
    assert "experiments" in by_file["actuator.mat"].detail
    for missing in ("ballbeam.dat", "drive.mat", "gas_furnace.csv", "dryer.dat"):
        assert not by_file[missing].ok and by_file[missing].detail == "missing"
    assert report(list(by_file.values())) is False
    out = capsys.readouterr().out
    assert "OK " in out and "FAIL" in out


def test_sysid_fixtures_pass(tmp_path):
    """Every system-identification file the port's synthetic stager
    writes passes both checkers (Sarcos, the five small-scale tasks)."""
    synthetic.sysid_files(str(tmp_path))
    d = str(tmp_path) + "/"
    for experiment in ("sarcos", "smallscale"):
        results = same_results(experiment, d)
        assert all(r.ok for r in results), results


def test_sarcos_fixture_passes(tmp_path, rng):
    d = str(tmp_path) + "/"
    scipy.io.savemat(d + "sarcos_inv.mat", {"sarcos_inv": rng.normal(size=(674 * 66, 28))})
    (result,) = same_results("sarcos", d)
    assert result.ok, result


def test_corrupt_file_fails_with_reason(tmp_path, rng):
    d = str(tmp_path) + "/"
    # wrong dims: spring expects u/y one-dimensional
    DSManager.save_ds(d + "spring_nonlinear.mat", rng.normal(size=(6000, 2)),
                      rng.normal(size=(6000, 3)), rng.normal(size=(6000, 1)), "bad")
    (result,) = same_results("spring", d)
    assert not result.ok and "dims" in result.detail
    # too short
    DSManager.save_ds(d + "spring_nonlinear.mat", rng.normal(size=(100, 1)),
                      rng.normal(size=(100, 3)), rng.normal(size=(100, 1)), "short")
    (result,) = same_results("spring", d)
    assert not result.ok and "samples" in result.detail
    # not a .mat file at all
    with open(d + "spring_nonlinear.mat", "wb") as f:
        f.write(b"\x00not a mat file")
    (result,) = same_results("spring", d)
    assert not result.ok and result.detail.startswith("unreadable")


def test_voliro_log_checks(tmp_path):
    d = str(tmp_path) + "/"
    synthetic.voliro_log(d + "voliro_tilt.mat", n=4000, seed=1)
    by_file = {r.file: r for r in same_results("voliro", d)}
    assert by_file["voliro_tilt.mat"].ok
    assert by_file["voliro_flip.mat"].detail == "missing"
    # a log shorter than the reference crop range fails
    synthetic.voliro_log(d + "voliro_flip.mat", n=5000, seed=2)
    by_file = {r.file: r for r in same_results("voliro", d)}
    assert not by_file["voliro_flip.mat"].ok
    assert "crop range" in by_file["voliro_flip.mat"].detail
    # a struct without the log keys
    scipy.io.savemat(d + "voliro_flip.mat", {"dataset": {"TIME_StartTime": np.zeros((9, 1))}})
    by_file = {r.file: r for r in same_results("voliro", d)}
    assert "log keys missing" in by_file["voliro_flip.mat"].detail


def test_unknown_experiment_rejected():
    with pytest.raises(ValueError, match="unknown experiment"):
        check_experiment("nope")


def test_cli_check_data_exit_codes(tmp_path, capsys):
    """Packaged spring data: exit 0; an empty directory: exit 1, nothing
    trained; the same codes as the JAX CLI."""
    for args, want in ((["reproduce", "spring", "--check-data"], 0),
                       (["reproduce", "sarcos", "--check-data", "--data-dir", str(tmp_path)], 1)):
        assert port_cli(args) == want
        out = capsys.readouterr().out
        assert jax_cli(args) == want
        assert capsys.readouterr().out == out
        assert ("ready to train" in out) == (want == 0)
        if want:
            assert "FAIL" in out and "missing" in out
