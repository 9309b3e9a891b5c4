"""``python -m cbfssm_tpu_torch``: the port's command line (CPU, every
model command with ``--device cpu``), the counterparts of
tests/test_cli.py: ``info`` with and without a trained directory, the
kwargs routing of ``reproduce`` and its refusals, ``eval`` from disk
alone reproducing the ``mse.txt`` of the ``reproduce`` run that wrote
the directory, the outputs-class mapping, auth-token resolution, and
``serve`` in a subprocess answering over HTTP and exiting 0 on
SIGTERM, and ``serve --filter`` (a FilterPool behind a FilterServer over
a CBFSSMHALF directory) likewise, with its refusals."""

import argparse
import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from cbfssm_tpu.__main__ import _eval_outputs_class as jax_outputs_class
from cbfssm_tpu.__main__ import build_parser as jax_parser
from cbfssm_tpu_torch import model_store, run_smallscale, run_spring, run_voliro
from cbfssm_tpu_torch.__main__ import (_eval_outputs_class, _resolve_auth_token, build_parser,
                                       main)
from cbfssm_tpu_torch.data import DSManager
from tests.test_torch_lanes import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 30
SPRING = ["--iterations", "1", "--train-iterations", "1", "--seq-len", "20",
          "--seq-stride", "100", "--device", "cpu"]


@pytest.fixture(scope="module")
def spring_dir(tmp_path_factory):
    """Spring fixture (5,300 samples: a 300-step test experiment)."""
    rng = np.random.default_rng(0)
    d = str(tmp_path_factory.mktemp("data")) + "/"
    DSManager.save_ds(d + "spring_nonlinear.mat", rng.normal(size=(5300, 1)),
                      rng.normal(size=(5300, 3)), rng.normal(size=(5300, 3)), "spring")
    return d


@pytest.fixture(scope="module")
def trained(tmp_path_factory, spring_dir):
    """One `reproduce spring` run at the driver's width, one epoch."""
    root = str(tmp_path_factory.mktemp("cli") / "out")
    assert main(["reproduce", "spring", "--root", root, "--data-dir", spring_dir, *SPRING]) == 0
    return root


def test_info_runs(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "torch " in out and "CUDA " in out and "devices:" in out
    assert "CBFSSM" in out and "reproduction drivers:" in out
    ds_line = next(ln for ln in out.splitlines() if ln.startswith("datasets:"))
    assert "Actuator" in ds_line and "RoboMove" in ds_line
    for base in ("BaseDS", "DSManager", "SystemIdDS"):
        assert base not in ds_line


def test_info_model_dir(trained, tmp_path, capsys):
    assert main(["info", trained]) == 0
    out = capsys.readouterr().out
    assert "CBFSSM (dim_u=1, dim_y=1, seed=0, ds=SpringNonlinear)" in out
    assert "checkpoints: best.ckpt, model.ckpt" in out
    assert "  gp_impl: \"pallas\"" in out and "  var_x: [" in out
    assert main(["info", str(tmp_path)]) == 2
    assert "model_meta.json" in capsys.readouterr().err


def test_reproduce_routes_kwargs(monkeypatch, tmp_path):
    """Only the kwargs a driver's main() accepts are passed, the device
    and the kernels' gp_impl among them."""
    seen = {}

    def spring_main(root=None, iterations=5, train_iterations=1, data_dir=None,
                    config_overrides=None, seq_len=50, seq_stride=1, vmap_seeds=False,
                    device="cuda"):
        kwargs = dict(locals())
        kwargs.pop("seen", None)  # the closure cell, not an argument
        seen.update(kwargs)

    monkeypatch.setattr(run_spring, "main", spring_main)
    assert main(["reproduce", "spring", "--root", str(tmp_path), "--vmap-seeds", *SPRING]) == 0
    assert seen == {"root": str(tmp_path), "iterations": 1, "train_iterations": 1,
                    "data_dir": None, "config_overrides": {"gp_impl": "pallas"},
                    "seq_len": 20, "seq_stride": 100, "vmap_seeds": True, "device": "cpu"}
    seen.clear()
    assert main(["reproduce", "spring"]) == 0
    assert seen["device"] == "cuda" and seen["config_overrides"] == {"gp_impl": "pallas"}
    seen.clear()
    assert main(["reproduce", "spring", *SPRING, "--epochs", "3"]) == 2  # no epochs in main
    assert seen == {}


def test_reproduce_rejects_unsupported_kwarg(capsys):
    """voliro's main() has no iterations: the CLI reports it."""
    assert main(["reproduce", "voliro", "--iterations", "3"]) == 2
    assert "does not accept ['iterations']" in capsys.readouterr().err


def test_reproduce_task_range_checked_first(monkeypatch, capsys):
    def never(**_kw):
        raise AssertionError("the driver ran")

    monkeypatch.setattr(run_smallscale, "main", never)
    n = len(run_smallscale.datasets)
    for task in (n, -1):
        assert main(["reproduce", "smallscale", "--task", str(task)]) == 2
        assert f"--task must be in [0, {n})" in capsys.readouterr().err
    monkeypatch.setattr(run_voliro, "main", never)
    assert main(["reproduce", "voliro", "--task", "0"]) == 2  # no task_list


def test_parser_rejects_unknown_experiment():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["reproduce", "nonsense"])
    with pytest.raises(SystemExit):
        build_parser().parse_args(["export", "x"])  # not ported


def test_parsers_share_options_with_jax():
    """Every option of the JAX CLI's info / reproduce / eval / serve that
    the port covers has the same spelling, plus --device."""

    def options(parser, command):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {s for a in sub.choices[command]._actions for s in a.option_strings}

    for command in ("info", "reproduce", "eval", "serve"):
        mine, theirs = options(build_parser(), command), options(jax_parser(), command)
        extra = set() if command == "info" else {"--device"}
        assert mine == theirs | extra, command
    args = build_parser().parse_args(["serve", "d", "--filter"])
    want = jax_parser().parse_args(["serve", "d", "--filter"])
    assert (args.filter, args.capacity, args.replay_buckets) == \
        (want.filter, want.capacity, want.replay_buckets) == (True, None, None)


def test_eval_reevaluates_from_disk(trained, spring_dir, tmp_path, capsys):
    """`eval <dir>` rebuilds model and dataset from model_meta.json alone
    and writes the artifact set; its mse.txt equals the one the
    reproduce run wrote, and the recipe round-trips."""
    evaldir = str(tmp_path / "reeval")
    rc = main(["eval", trained, "--out", evaldir, "--data-dir", spring_dir, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for f in ("mse.txt", "calibration.txt", "predict_test.pdf", "var_dump.txt"):
        assert os.path.getsize(os.path.join(evaldir, f)) > 0, f
    assert "RMSE:" in out and "NLL/point:" in out
    for f in ("mse.txt", "calibration.txt"):
        with open(os.path.join(trained, f)) as a, open(os.path.join(evaldir, f)) as b:
            assert a.read() == b.read(), f
    recipe = model_store.load_model_meta(trained)["dataset"]
    assert recipe == {"name": "SpringNonlinear", "seq_len": 20, "seq_stride": 100}


def test_eval_requires_meta(tmp_path, capsys):
    assert main(["eval", str(tmp_path / "nothing_here"), "--device", "cpu"]) == 2
    assert "error" in capsys.readouterr().err


def test_eval_outputs_class_mapping():
    from cbfssm_tpu_torch.outputs import Outputs, OutputsRoboMove, OutputsVoliro

    cases = {("Voliro", "VoliroTiltDS"): OutputsVoliro, ("CBFSSM", "RoboMove"): OutputsRoboMove,
             ("CBFSSM", "RoboMoveSimple"): OutputsRoboMove,
             ("CBFSSM", "SpringNonlinear"): Outputs, ("PRSSM", "Actuator"): Outputs}
    for args, want in cases.items():
        assert _eval_outputs_class(*args) is want
        assert jax_outputs_class(*args).__name__ == want.__name__


def test_serve_auth_token_resolution(monkeypatch, capsys):
    """--auth-token beats the env var; empty means open; a tokenless
    non-loopback bind warns."""
    def ns(**kw):
        return argparse.Namespace(auth_token=kw.get("auth_token"),
                                  host=kw.get("host", "127.0.0.1"))

    monkeypatch.delenv("CBFSSM_AUTH_TOKEN", raising=False)
    assert _resolve_auth_token(ns()) is None
    assert _resolve_auth_token(ns(auth_token="flag")) == "flag"
    monkeypatch.setenv("CBFSSM_AUTH_TOKEN", "envtok")
    assert _resolve_auth_token(ns()) == "envtok"
    assert _resolve_auth_token(ns(auth_token="flag")) == "flag"
    monkeypatch.setenv("CBFSSM_AUTH_TOKEN", "")
    assert _resolve_auth_token(ns()) is None
    capsys.readouterr()
    monkeypatch.delenv("CBFSSM_AUTH_TOKEN", raising=False)
    assert _resolve_auth_token(ns(host="0.0.0.0")) is None
    assert "non-loopback" in capsys.readouterr().err
    assert _resolve_auth_token(ns(host="0.0.0.0", auth_token="t")) == "t"
    assert "non-loopback" not in capsys.readouterr().err


def test_serve_refuses_what_it_cannot_serve(trained, tmp_path, capsys):
    assert main(["serve", str(tmp_path), "--device", "cpu"]) == 2
    assert "no model_meta.json" in capsys.readouterr().err
    art = tmp_path / "art"
    art.mkdir()
    (art / "meta.json").write_text(json.dumps({"kind": "predictor"}))
    assert main(["serve", str(art), "--device", "cpu"]) == 2
    assert "not served by the port yet" in capsys.readouterr().err
    assert main(["serve", trained, "--device", "cpu", "--buckets"]) == 2
    assert "bucket" in capsys.readouterr().err


def test_serve_subprocess_answers_and_exits_on_sigterm(trained):
    """`serve <dir> --device cpu --port 0` in its own process (the SIGTERM
    handler needs the main thread): the banner, /healthz, one predict
    of the stamped window length, then SIGTERM ends it with exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "cbfssm_tpu_torch", "serve", trained, "--device", "cpu",
         "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "http://" in line and "seq_len 20" in line, (line, proc.stderr.read())
        base = line.strip().rsplit(" ", 1)[1]
        with urllib.request.urlopen(base + "/healthz", timeout=TIMEOUT) as r:
            assert json.loads(r.read()) == {"ok": True}
        body = json.dumps({"u": np.zeros((20, 1)).tolist(), "y": np.zeros((20, 1)).tolist()})
        req = urllib.request.Request(base + "/v1/predict", data=body.encode(), method="POST")
        req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert np.isfinite(json.loads(r.read())["pred_mean"]).all()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, (proc.returncode, err)
        assert "shutting down" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)


@pytest.fixture(scope="module")
def half_dir(tmp_path_factory):
    """A CBFSSMHALF directory as a trainer leaves it (model_meta.json and
    best.ckpt), from tests/test_other_models.py's tiny config."""
    import torch

    from cbfssm_tpu_torch.models import CBFSSMHALF
    from cbfssm_tpu_torch.training import checkpoint
    from tests.test_other_models import half_config

    d = str(tmp_path_factory.mktemp("half"))
    model = CBFSSMHALF(dict(half_config("rnn"), gp_impl="pallas"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    model_store.save_model_meta(d, model)
    checkpoint.save(os.path.join(d, checkpoint.BEST), {"params": params.tensors()})
    return d


def test_serve_filter_subprocess_answers_and_exits_on_sigterm(half_dir):
    """`serve --filter <dir> --device cpu --port 0`: the JAX banner, one
    attach and one step over HTTP, then SIGTERM ends it with exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "cbfssm_tpu_torch", "serve", "--filter", half_dir, "--device",
         "cpu", "--port", "0", "--capacity", "4", "--replay-buckets", "2", "8"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def post(url, body):
        req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
        req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return json.loads(r.read())

    try:
        line = proc.stdout.readline()
        assert line.startswith("serving CBFSSMHALF filter sessions (capacity 4, recog_len 4, "
                               "dim_u 2, dim_y 1, float64, auth off) on http://"), \
            (line, proc.stderr.read())
        base = line.strip().rsplit(" ", 1)[1]
        sid = post(base + "/v1/sessions", {"u_prefix": np.zeros((4, 2)).tolist(),
                                           "y_prefix": np.zeros((4, 1)).tolist()})["sid"]
        out = post(f"{base}/v1/sessions/{sid}/step", {"u_prev": [0.1, 0.2], "y_new": [0.3]})
        assert sid == 0 and np.isfinite(out["mean"]).all() and np.all(np.asarray(out["var"]) > 0)
        out = post(f"{base}/v1/sessions/{sid}/replay", {"u": np.zeros((3, 2)).tolist(),
                                                       "y": np.zeros((3, 1)).tolist()})
        assert np.asarray(out["mean"]).shape == (3, 1)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, (proc.returncode, err)
        assert "shutting down" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)


def test_serve_filter_refuses_what_it_cannot_serve(trained, half_dir, tmp_path, capsys):
    """A model without the streaming interface, an exported artifact, a
    directory without model_meta.json and a capacity of 0 exit 2."""
    assert main(["serve", "--filter", trained, "--device", "cpu"]) == 2
    assert ("CBFSSM has no streaming interface (filter_ops); FilterPool supports CBFSSMHALF "
            "and Voliro") in capsys.readouterr().err
    art = tmp_path / "art"
    art.mkdir()
    (art / "meta.json").write_text(json.dumps({"kind": "filter_pool"}))
    assert main(["serve", "--filter", str(art), "--device", "cpu"]) == 2
    assert "not served by the port yet" in capsys.readouterr().err
    assert main(["serve", "--filter", str(tmp_path), "--device", "cpu"]) == 2
    assert "no model_meta.json" in capsys.readouterr().err
    assert main(["serve", "--filter", half_dir, "--device", "cpu", "--capacity", "0"]) == 2
    assert "capacity must be >= 1" in capsys.readouterr().err
