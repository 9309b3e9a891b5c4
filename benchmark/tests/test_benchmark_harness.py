"""The harness end to end on the CPU at a tiny size, its result line,
``BENCHMARK.json`` against the contract, files found by name, faults
caught, and no JAX in a run."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import faults, harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {
    "robomove-train": {"model": {"batch_size": 4, "samples": 2, "ind_pnt_num": 5,
                                 "recog_len": 5},
                       "data": {"seq_len": 30, "seq_stride": 500},
                       "traffic": {"trace_steps": 4}},
    "voliro-train": {"model": {"batch_size": 8, "samples": 2, "ind_pnt_num": 5,
                               "epochs_per_dispatch": 2},
                     "traffic": {"trace_steps": 2}},
}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_runs_end_to_end_on_the_cpu(workload, trace):
    out = harness.execute(workload, 2 ** 31 + 12345, 0.5, bool(trace), device="cpu",
                          overrides=TINY[workload])
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = harness.Cell(workload)
    if trace:
        assert set(out["metrics"]) <= {m["name"] for m in cell.metrics("per_layer")}
        assert "mfu.train" in out["metrics"]  # the others read the card's trace
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.metrics("end_to_end")}
        for m in cell.metrics("end_to_end"):
            assert out["metrics"][m["name"]]["unit"] == m["unit"]
    for check in out["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(out, allow_nan=False)


def frozen(orig):
    """The step hands its state back unchanged: parameters and Adam's
    moments as they were before it."""
    def step(self, u, y, w, generator=None, noise=None):
        before = [p.detach().clone() for p in self.params.tensors()]
        out = orig(self, u, y, w, generator, noise)
        with torch.no_grad():
            for p, b in zip(self.params.tensors(), before):
                p.copy_(b)
            for st in self.optimizer.state.values():
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    st[key].zero_()
        return out
    return step


FAULTS = {"frozen": frozen, "half_batch": faults.half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_broken_step_is_not_correct(workload, fault):
    """The faults a training cell can have, planted under a whole run:
    a step that hands its state back unchanged, and half of each batch
    left out with the mean taken over the rest."""
    with faults.planted(FAULTS[fault]):
        out = harness.execute(workload, 77, 0.5, False, device="cpu", overrides=TINY[workload])
    assert out["correct"] is False
    assert out["checks"]["grad"]["value"] > out["checks"]["grad"]["limit"]


def test_run_py_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "robomove-train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "cuda" in proc.stderr.lower()


def test_run_py_without_the_program_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark (on the
    card the program's import, or an installed copy outside the
    directory, stops it; here the missing card does first)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "robomove-train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_json_follows_the_contract():
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    cells = len(spec["workloads"])
    assert 2 + 14 * 24 * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24 and sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, cells // 4)
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    for entry in spec["workloads"]:
        names += [entry["config"], entry["traffic"]]
    for c in spec["configs"]:
        names += c["reduced"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in spec[kind]}) == len(spec[kind])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "bound" in m:
            assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
            assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
            assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
            moved = [e for e in spec["end_to_end"] if e["name"] == m["moves"]][0]
            for w in m.get("workloads", [w["name"] for w in spec["workloads"]]):
                assert w in moved.get("workloads", [w]), (m["name"], w)
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        traffic = harness.load_json(ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json")
        assert (ROOT / "benchmark" / "mixes" / f"{traffic['mix']}.py").is_file()
    texts = [c["why"] for c in spec["configs"]] + [c["source"] for c in spec["configs"]]
    texts += [m["layer"] for m in spec["per_layer"]] + spec["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_new_files_are_picked_up_by_name(tmp_path):
    """A configuration, a mix and a metric added as files, with entries in
    BENCHMARK.json, run with no edit to any file the benchmark has."""
    for part in ("benchmark", "cbfssm_tpu_torch"):  # a checkout: the benchmark and the program
        shutil.copytree(ROOT / part, tmp_path / part, ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cfg = harness.load_json(ROOT / "benchmark/configs/robomove.json")
    cfg["model"].update(TINY["robomove-train"]["model"])
    cfg["data"].update(TINY["robomove-train"]["data"])
    (tmp_path / "benchmark/configs/robomove_tiny.json").write_text(json.dumps(cfg))
    traffic = harness.load_json(ROOT / "benchmark/traffic/train.json")
    (tmp_path / "benchmark/traffic/train_short.json").write_text(
        json.dumps(dict(traffic, trace_steps=2)))
    (tmp_path / "benchmark/metrics/traced_s.train.py").write_text(
        "def read(summary):\n    return summary['window_s']\n")
    spec["configs"].append(dict(spec["configs"][0], name="robomove_tiny",
                                file="benchmark/configs/robomove_tiny.json"))
    spec["workloads"].append({"name": "tiny", "config": "robomove_tiny",
                              "traffic": "train_short", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "traced_s.train", "unit": "s", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "train_steps_per_s", "workloads": ["tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "print(json.dumps(harness.execute('tiny', 5, 0.5, True, device='cpu')))"
            % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metrics"]["traced_s.train"]["value"] == out["device"]["window_s"]


COUNT_MIX = '''"""A mix that counts in its window (a test's)."""
import time

from benchmark import harness


def measure(cell, seed, seconds, trace, device):
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        n += 1
    return {"values": {"setup_s": 0.25, "counts_per_s": n / seconds}, "attempted": n,
            "failed": 0, "checks": harness.checks({"exact": 0.0}, {"exact": 0.0}),
            "peak_bytes": 0, "summary": None}
'''


def test_a_new_mix_brings_its_own_end_to_end_metric(tmp_path):
    """A mix added as a module and a traffic file, with an end-to-end
    metric of its own that only its cell reports: no edit to any file
    the benchmark has."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark/mixes/count.py").write_text(COUNT_MIX)
    (tmp_path / "benchmark/traffic/count.json").write_text(json.dumps({"mix": "count"}))
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    spec["workloads"].append({"name": "counter", "config": "robomove", "traffic": "count",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "counts_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": ["counter"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "print(json.dumps([harness.execute('counter', 5, 0.3, False, device='cpu'),"
            " [m['name'] for m in harness.Cell('robomove-train').metrics('end_to_end')]]))"
            % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out, train_metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out["metrics"]) == {"setup_s", "counts_per_s"}
    assert out["metrics"]["counts_per_s"]["value"] > 0 and out["correct"] is True
    assert "counts_per_s" not in train_metrics


def test_a_run_loads_no_jax():
    """Top-level module names compared whole: the port's ``cbfssm_tpu_torch``
    is loaded, the JAX package ``cbfssm_tpu`` and JAX are not."""
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "harness.execute('voliro-train', 3, 0.5, False, device='cpu', overrides=%r)\n"
            "print(json.dumps([harness.forbidden_modules(), "
            "sorted({m.split('.')[0] for m in sys.modules})]))"
            % (str(ROOT), TINY["voliro-train"]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    forbidden, top = json.loads(proc.stdout.strip().splitlines()[-1])
    assert forbidden == []
    assert "cbfssm_tpu_torch" in top and not {"jax", "jaxlib", "flax", "cbfssm_tpu"} & set(top)


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "voliro-train",
                           "--seed", "4294967311", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
