"""The port's bench (``cbfssm_tpu_torch.bench``) against the JAX
package's ``bench.py`` (CPU): the analytic GFLOPs (rtol 1e-12), the
headline and CBFSSM-shape configs key for key and their inputs byte for
byte, one float64 headline step against ``jax.value_and_grad(model.loss)``
+ ``optax.adam(0.01)`` on the same params (``convert``) and the same noise
(the JAX key schedule): loss and gradients rtol 1e-7, params after the
update within 1e-10; then the result line, the watchdog and SIGTERM
salvage (subprocesses at tiny timeouts, as
``tests/test_bench_accounting.py``), the CPU-baseline child protocol, the
stages at tiny sizes and the ``bench`` subcommand."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import bench as jbench
import cbfssm_tpu.models
from cbfssm_tpu_torch import bench as pbench
from cbfssm_tpu_torch import convert
from cbfssm_tpu_torch.__main__ import main as cli_main
from cbfssm_tpu_torch.training import Trainer
from scripts import profile_mfu
from tests.test_torch_lanes import one_thread  # noqa: F401 (autouse)
from tests.test_torch_voliro import jax_noise, params_numpy

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(BATCH=2, SEQ_LEN=8, SAMPLES=2)
RTOL = 1e-7
PARAM_ATOL = 1e-10


class Unbuilt:
    """Stands for a JAX model that was not built (its params are None)."""

    def init(self, key):
        return None


def recording(mp, name):
    """Records the config dicts the JAX package's model ``name`` would be
    built from (the JAX bench imports the class at call time), and builds
    none."""
    seen = []

    def build(config):
        seen.append(config)
        return Unbuilt()

    mp.setattr(cbfssm_tpu.models, name, build)
    return seen


def assert_same_config(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key == "ds":
            assert (got[key].dim_u, got[key].dim_y) == (value.dim_u, value.dim_y)
        else:
            assert type(got[key]) is type(value), key
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)


# --- the numbers the two benches share -------------------------------------


@pytest.mark.parametrize("name", ["robomove", "sarcos", "smallscale", "voliro"])
def test_analytic_gflops_equal_jax(name):
    if name == "voliro":
        got, want = pbench.voliro_analytic_gflops(), jbench.voliro_analytic_gflops()
    else:
        assert pbench.SHAPES[name] == profile_mfu.SHAPES[name]
        got = pbench.cbfssm_analytic_gflops(pbench.SHAPES[name])
        want = jbench.cbfssm_analytic_gflops(profile_mfu.SHAPES[name])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got > 0


def test_headline_inputs_and_config_equal_jax(monkeypatch):
    seen = recording(monkeypatch, "Voliro")
    _, _, ju, jy = jbench.build_voliro_parts()
    model, params, u, y = pbench.build_voliro_parts(device="cpu")
    assert u.dtype == ju.dtype and u.tobytes() == ju.tobytes()
    assert y.dtype == jy.dtype and y.tobytes() == jy.tobytes()
    assert_same_config(pbench.voliro_config(), seen[0])
    assert (pbench.BATCH, pbench.SEQ_LEN, pbench.SAMPLES, pbench.STEPS, pbench.WARMUP) == (
        jbench.BATCH, jbench.SEQ_LEN, jbench.SAMPLES, jbench.STEPS, jbench.WARMUP)
    assert model.dtype == torch.float32 and model.config.gp_impl == "solve_free"
    assert all(t.device.type == "cpu" for t in params.tensors())


@pytest.mark.parametrize("name", ["robomove", "sarcos", "smallscale"])
def test_shape_inputs_and_config_equal_jax(monkeypatch, name):
    seen = recording(monkeypatch, "CBFSSM")
    *_, ju, jy = profile_mfu.build_cbfssm_parts(profile_mfu.SHAPES[name])
    _, _, u, y = pbench.build_cbfssm_parts(pbench.SHAPES[name], device="cpu")
    assert u.tobytes() == ju.tobytes() and y.tobytes() == jy.tobytes()
    assert_same_config(pbench.cbfssm_config(pbench.SHAPES[name]), seen[0])


@pytest.fixture(scope="module")
def f64_steps():
    """One float64 headline step of each package at TINY, from the same
    params and noise: JAX's (loss, grads, params after optax.adam) and
    the port's ``Step`` (loss, grads, leaves after the update)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbench, pbench):
            for k, v in TINY.items():
                mp.setattr(mod, k, v)
        real = cbfssm_tpu.models.Voliro
        seen = recording(mp, "Voliro")
        _, _, u, y = jbench.build_voliro_parts()
        jm = real(dict(seen[0], dtype="float64"))
        jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
        key = jax.random.fold_in(jax.random.PRNGKey(1), 0)
        tx = optax.adam(pbench.LEARNING_RATE)

        @jax.jit
        def jax_step(p):
            (loss, _), grads = jax.value_and_grad(
                lambda q: jm.loss(q, u, y, key, True), has_aux=True)(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            return loss, grads, optax.apply_updates(p, updates)

        jloss, jgrads, jnew = jax_step(jparams)

        real_config = pbench.voliro_config
        mp.setattr(pbench, "voliro_config",
                   lambda adjoint="auto": dict(real_config(adjoint), dtype="float64"))
        model, params, pu, py = pbench.build_voliro_parts(
            device="cpu",
            params=convert.voliro_params_from_numpy(params_numpy(jparams), device="cpu"))
        assert model.dtype == torch.float64
        assert pu.tobytes() == u.tobytes() and py.tobytes() == y.tobytes()
        step = pbench.Step(model, params, pu, py, pbench.LEARNING_RATE)
        noise = jax_noise(key, TINY["BATCH"], TINY["SEQ_LEN"], TINY["SAMPLES"])
        loss, grads = step(noise=noise)

    def leaves(tree):
        return [t.numpy() for t in convert.voliro_params_from_numpy(
            params_numpy(tree), device="cpu").tensors()]

    return {"jax": (float(jloss), leaves(jgrads), leaves(jnew)),
            "port": (loss.item(), [g.numpy() for g in grads],
                     [t.detach().numpy() for t in step.leaves])}


def test_f64_step_loss_matches_jax(f64_steps):
    np.testing.assert_allclose(f64_steps["port"][0], f64_steps["jax"][0], rtol=RTOL)


def test_f64_step_gradients_match_jax(f64_steps):
    got, want = f64_steps["port"][1], f64_steps["jax"][1]
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)


def test_f64_step_adam_update_matches_optax(f64_steps):
    got, want = f64_steps["port"][2], f64_steps["jax"][2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL)


# --- the result line ----------------------------------------------------------


def test_emit_json_keys(capsys):
    results = {"value": 1.5, "vs_baseline": 3.0, "analytic_gflop_per_step": 0.2,
               "mfu_vs_f32_peak": 4e-6, "shapes": {"robomove": {}},
               "steps_per_sec_300_per_dispatch": 1.6, "trainer_blocked_steps_per_sec": 1.4,
               "multiseed_5x_s_per_epoch": 9.0, "baseline_error": "x",
               "device": {"name": "card", "power_limit": "700.00 W"},
               "stage_seconds": {"headline": 1.0}, "unlisted": 1}
    payload = pbench._emit_json(results)
    assert json.loads(capsys.readouterr().out.strip()) == payload
    assert payload["metric"] == "voliro_elbo_steps_per_sec" and payload["unit"] == "steps/sec"
    assert "error" not in payload and "stage" not in payload and "unlisted" not in payload
    assert {k: payload[k] for k in results if k != "unlisted"} == {
        k: v for k, v in results.items() if k != "unlisted"}
    # a stage not measured stays absent, not null
    payload = pbench._emit_json({}, error="x" * 1000, stage="shapes")
    capsys.readouterr()
    assert payload["value"] is None and payload["vs_baseline"] is None
    assert payload["stage"] == "shapes" and len(payload["error"]) == 500
    assert "trainer_blocked_steps_per_sec" not in payload and "device" not in payload


def run_child(code, timeout=60):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)


def test_watchdog_fires_on_a_stalled_first_stage():
    out = run_child("import time\nfrom cbfssm_tpu_torch import bench\n"
                    "bench._start_watchdog({'name': 'backend-init'}, {}, first_timeout=0.5,"
                    " total_timeout=60, poll=0.2)\ntime.sleep(30)\n")
    assert out.returncode == 3
    assert "watchdog" in out.stderr and "headline" in out.stderr
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["stage"] == "backend-init" and payload["value"] is None


def test_watchdog_salvages_partial_results():
    out = run_child("import time\nfrom cbfssm_tpu_torch import bench\n"
                    "results = {'value': 1.25, 'vs_baseline': 30.0, 'shapes': {'x': {}},"
                    " 'device': {'name': 'card', 'power_limit': '700.00 W'}}\n"
                    "bench._start_watchdog({'name': 'trainer-blocked'}, results,"
                    " first_timeout=60, total_timeout=0.5, poll=0.2)\ntime.sleep(30)\n")
    assert out.returncode == 3
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["value"] == 1.25 and payload["vs_baseline"] == 30.0
    assert payload["shapes"] == {"x": {}} and payload["device"]["name"] == "card"
    assert payload["stage"] == "trainer-blocked" and "exceeded" in payload["error"]


def test_signal_salvage_emits_partial_json():
    code = ("import sys, time\nfrom cbfssm_tpu_torch import bench\n"
            "bench._install_signal_salvage({'name': 'shapes'}, {'value': 1.25})\n"
            "print('ready', file=sys.stderr, flush=True)\ntime.sleep(60)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        assert proc.stderr.readline().strip() == "ready"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        proc.kill()
    assert proc.returncode == 3
    payload = json.loads(out.strip().splitlines()[-1])
    assert payload["value"] == 1.25 and payload["stage"] == "shapes"
    assert "signal" in payload["error"]


def test_watchdog_total_timeout_env_override(monkeypatch):
    import threading

    monkeypatch.setenv("CBFSSM_BENCH_TOTAL_TIMEOUT", "1")
    calls = {}
    park = threading.Event()

    def fake_exit(rc):
        calls.setdefault("rc", rc)
        park.wait()  # parks the daemon thread; reaped at process exit

    monkeypatch.setattr(pbench.os, "_exit", fake_exit)
    pbench._start_watchdog({"name": "shapes"}, {}, poll=0.05, emit=False)
    deadline = time.monotonic() + 10
    while "rc" not in calls and time.monotonic() < deadline:
        time.sleep(0.05)
    assert calls.get("rc") == 3


# --- the stages and main --------------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    """_run_stages on the CPU: a card that is "there", named by a stub."""
    monkeypatch.setattr(pbench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pbench, "device_info",
                        lambda: {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"})
    monkeypatch.delenv("CBFSSM_BENCH_HEADLINE_ONLY", raising=False)


def stub_stages(monkeypatch, baseline=(0.5, None)):
    calls = []

    def measure(steps=pbench.STEPS, warmup=pbench.WARMUP, device="cuda"):
        calls.append(("measure", steps, warmup, device))
        return 2.0 if steps == pbench.STEPS else 2.5

    monkeypatch.setattr(pbench, "measure", measure)
    monkeypatch.setattr(pbench, "cpu_baseline", lambda: baseline)
    monkeypatch.setattr(pbench, "measure_cbfssm_shapes", lambda: {"robomove": {"e": 1}})
    monkeypatch.setattr(pbench, "measure_trainer", lambda: 1.75)
    monkeypatch.setattr(pbench, "measure_multiseed", lambda: 12.5)
    return calls


def test_run_stages_emits_every_stage(card, monkeypatch, capsys):
    calls = stub_stages(monkeypatch)
    payload = pbench._run_stages({"name": "backend-init"}, {})
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == payload
    assert calls == [("measure", 30, 3, "cuda"), ("measure", 300, 2, "cuda")]
    gflops = pbench.voliro_analytic_gflops()
    assert payload["value"] == 2.0 and payload["vs_baseline"] == 4.0
    assert payload["analytic_gflop_per_step"] == round(gflops, 3)
    assert payload["mfu_vs_f32_peak"] == gflops * 1e9 * 2.0 / 67e12
    assert payload["steps_per_sec_300_per_dispatch"] == 2.5
    assert payload["trainer_blocked_steps_per_sec"] == 1.75
    assert payload["multiseed_5x_s_per_epoch"] == 12.5
    assert payload["shapes"] == {"robomove": {"e": 1}}
    assert payload["device"] == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    assert sorted(payload["stage_seconds"]) == sorted(
        ["headline", "cpu-baseline", "shapes", "large-chunk", "trainer-blocked", "multiseed"])
    assert "baseline_error" not in payload and "error" not in payload


def test_headline_only_and_failed_baseline(card, monkeypatch, capsys):
    stub_stages(monkeypatch, baseline=(None, "CalledProcessError: child died"))
    monkeypatch.setenv("CBFSSM_BENCH_HEADLINE_ONLY", "1")
    payload = pbench._run_stages({"name": "backend-init"}, {})
    capsys.readouterr()
    assert payload["value"] == 2.0
    assert payload["vs_baseline"] is None and "child died" in payload["baseline_error"]
    for key in ("shapes", "steps_per_sec_300_per_dispatch", "trainer_blocked_steps_per_sec",
                "multiseed_5x_s_per_epoch"):
        assert key not in payload
    assert sorted(payload["stage_seconds"]) == ["cpu-baseline", "headline"]


def test_main_salvages_a_stage_that_raises(card, monkeypatch, capsys):
    monkeypatch.setenv("CBFSSM_BENCH_NO_WATCHDOG", "1")
    monkeypatch.delenv("CBFSSM_BENCH_CPU_CHILD", raising=False)
    monkeypatch.setattr(pbench, "_install_signal_salvage", lambda stage, results: None)
    stub_stages(monkeypatch)

    def boom():
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(pbench, "measure_cbfssm_shapes", boom)
    with pytest.raises(SystemExit) as e:
        pbench.main()
    assert e.value.code == 3
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["stage"] == "shapes" and "illegal memory" in payload["error"]
    assert payload["value"] == 2.0 and payload["vs_baseline"] == 4.0
    assert payload["device"]["name"] == "NVIDIA H100 80GB HBM3"


def test_main_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setenv("CBFSSM_BENCH_NO_WATCHDOG", "1")
    monkeypatch.delenv("CBFSSM_BENCH_CPU_CHILD", raising=False)
    monkeypatch.setattr(pbench, "_install_signal_salvage", lambda stage, results: None)
    monkeypatch.setattr(pbench.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        pbench.main()
    assert e.value.code == 3
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["value"] is None and "cuda" in payload["error"]


# --- the CPU baseline -----------------------------------------------------------

CHILD_STUB = (
    "import os\nimport cbfssm_tpu_torch.bench as b\n"
    "assert os.environ['CUDA_VISIBLE_DEVICES'] == ''\n"
    "b.measure = lambda steps, warmup, device: float(10 * steps + warmup) if device == 'cpu'"
    " else 0.0\n"
    "b.main()\n")


def test_cpu_child_prints_its_record(monkeypatch, capsys):
    monkeypatch.setenv("CBFSSM_BENCH_CPU_CHILD", "1")
    monkeypatch.setenv("CBFSSM_BENCH_NO_WATCHDOG", "1")
    seen = []
    monkeypatch.setattr(pbench, "measure",
                        lambda steps, warmup, device: seen.append((steps, warmup, device)) or 3.5)
    pbench.main()
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen == [(5, 2, "cpu")]
    assert record["metric"] == "cpu_child" and record["value"] == 3.5
    assert record["cpu"] == pbench.cpu_name() and record["torch_threads"] >= 1


def test_cpu_baseline_child_and_cache(tmp_path, monkeypatch):
    cache = tmp_path / "bench_cpu_baseline.json"
    monkeypatch.setattr(pbench, "BASELINE_CACHE", cache)
    monkeypatch.setattr(pbench, "CPU_CHILD", ("-c", CHILD_STUB))
    monkeypatch.delenv("CBFSSM_BENCH_CPU_CHILD", raising=False)
    assert pbench.cpu_baseline() == (52.0, None)
    saved = json.loads(cache.read_text())
    assert saved["cpu_torch_steps_per_sec"] == 52.0
    assert saved["cpu"] == pbench.cpu_name() and saved["torch_threads"] >= 1
    assert os.listdir(tmp_path) == [cache.name]  # written whole: no temporary left
    # the cache answers; no child runs
    monkeypatch.setattr(pbench, "CPU_CHILD", ("-c", "raise SystemExit(1)"))
    assert pbench.cpu_baseline() == (52.0, None)


def test_corrupt_cache_is_measured_again(tmp_path, monkeypatch, capsys):
    cache = tmp_path / "bench_cpu_baseline.json"
    cache.write_text('{"cpu_torch_steps_per_sec": 26.')  # a torn write
    monkeypatch.setattr(pbench, "BASELINE_CACHE", cache)
    line = json.dumps({"metric": "cpu_child", "value": 52.0, "cpu": "x", "torch_threads": 1})
    monkeypatch.setattr(pbench.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a[0], 0, stdout=f"noise\n{line}\n", stderr=""))
    assert pbench.cpu_baseline() == (52.0, None)
    assert "unreadable" in capsys.readouterr().err
    assert json.loads(cache.read_text())["cpu_torch_steps_per_sec"] == 52.0


def test_failed_child_gives_null_baseline(tmp_path, card, monkeypatch, capsys):
    cache = tmp_path / "bench_cpu_baseline.json"
    monkeypatch.setattr(pbench, "BASELINE_CACHE", cache)
    monkeypatch.setattr(pbench, "CPU_CHILD", ("-c", "raise SystemExit(1)"))
    value, error = pbench.cpu_baseline()
    assert value is None and "IndexError" in error
    assert not cache.exists()
    real = pbench.cpu_baseline
    stub_stages(monkeypatch)
    monkeypatch.setattr(pbench, "cpu_baseline", real)
    monkeypatch.setenv("CBFSSM_BENCH_HEADLINE_ONLY", "1")
    payload = pbench._run_stages({"name": "backend-init"}, {})
    capsys.readouterr()
    assert payload["vs_baseline"] is None and payload["baseline_error"] == error


# --- the stages at tiny sizes on the CPU ----------------------------------------


@pytest.fixture
def tiny(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setattr(pbench, k, v)
    monkeypatch.setattr(pbench, "N_TRAIN_WINDOWS", 2)
    monkeypatch.setattr(pbench, "N_TEST_WINDOWS", 2)


def test_measure_and_chunks_run_tiny(tiny):
    assert 0 < pbench.measure(steps=2, warmup=1, device="cpu") < 1e6
    model, params, u, y = pbench.build_voliro_parts(device="cpu")
    step = pbench.Step(model, params, u, y, pbench.LEARNING_RATE)
    a = step.chunk(2, 7)
    assert np.isfinite(a) and len(step.states[0]) == 3
    assert float(step.states[0]["step"]) == 2.0
    # a chunk's noise comes from its seed alone
    again = pbench.Step(model, params, u, y, pbench.LEARNING_RATE)
    assert again.chunk(2, 7) == a


def test_measure_cbfssm_shapes_runs_tiny(monkeypatch):
    monkeypatch.setattr(pbench, "SHAPES", {
        "tiny": dict(batch=2, seq_len=12, samples=2, m=5, dim_x=4, dim_u=1, dim_y=1,
                     recog_len=3, lr=0.1),
        "broken": dict(batch=2)})
    out = pbench.measure_cbfssm_shapes(steps=2, reps=1, device="cpu")
    assert out["broken"] == {"error": "KeyError: 'dim_u'"}
    assert out["tiny"]["steps_per_sec"] > 0
    assert out["tiny"]["analytic_gflop_per_step"] == round(
        pbench.cbfssm_analytic_gflops(pbench.SHAPES["tiny"]), 3)


def test_measure_trainer_runs_tiny(tiny):
    assert 0 < pbench.measure_trainer(epochs=11, device="cpu") < 1e6
    with pytest.raises(ValueError, match="warmup"):
        pbench.measure_trainer(epochs=10, device="cpu")


def test_measure_multiseed_runs_tiny(monkeypatch):
    from cbfssm_tpu_torch import run_spring

    monkeypatch.setattr(run_spring, "model_config",
                        dict(run_spring.model_config, samples=2, ind_pnt_num=5, batch_size=20,
                             recog_len=4))
    monkeypatch.setattr(run_spring, "seq_len", 30)
    monkeypatch.setattr(run_spring, "seq_stride", 300)
    assert 0 < pbench.measure_multiseed(seeds=2, epochs=4, warm=1, device="cpu") < 300


def test_marks_count_issued_epochs(tiny, tmp_path):
    """A block's epochs are logged after the next block was issued: each
    mark counts the epochs issued by then."""
    model, ds = pbench.build_ds("cpu")
    trainer = Trainer(model, str(tmp_path), epochs_per_dispatch=2, seed=0)
    marks = []
    pbench._mark_epochs(trainer, marks)
    trainer.train(ds, 6)
    assert [c for c, _ in marks] == [4, 4, 6, 6, 6, 6]
    assert [t for _, t in marks] == sorted(t for _, t in marks)
    trainer = Trainer(model, str(tmp_path), epochs_per_dispatch=1, seed=0)
    marks = []
    pbench._mark_epochs(trainer, marks)
    trainer.train(ds, 3)
    assert [c for c, _ in marks] == [1, 2, 3]


def test_tail_seconds_per_epoch():
    marks = [(4, 1.0), (4, 1.5), (12, 3.0), (12, 3.5), (20, 9.0)]
    # the first mark with >= 10 issued: 8 epochs left after t = 3.0
    assert pbench._tail_seconds_per_epoch(marks, 10, 20, 0.0, 11.0) == 1.0
    # no mark qualifies: the whole run
    assert pbench._tail_seconds_per_epoch([(20, 5.0)], 10, 20, 1.0, 11.0) == 0.5


# --- the subcommand -------------------------------------------------------------


def test_cli_lists_and_runs_bench(monkeypatch, capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["--help"])
    out = capsys.readouterr().out
    assert e.value.code == 0 and "headline ELBO steps/sec benchmark" in out
    ran = []
    monkeypatch.setattr(pbench, "main", lambda: ran.append(1))
    assert cli_main(["bench"]) == 0 and ran == [1]

