"""One run of one cell: its files found by name, the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic file
(``benchmark/traffic/<traffic>.json``). The traffic file's ``mix`` names
the module that runs it (``benchmark/mixes/<mix>.py``: set-up, the
measured window, the check), and its other keys are that module's
parameters. The configuration's ``kind`` names its plain reference
(``benchmark/reference/<kind>.py``: data, weights, draws, loss, analytic
operations) and its ``program`` names the port's classes. Per-layer
metrics are read by ``benchmark/metrics/<metric>.py``. Nothing here
names a cell, a mix or a metric.

A mix's ``measure(cell, seed, seconds, trace, device)`` returns the
run's end-to-end values by metric name (``values``), ``attempted``,
``failed``, the numbers compared beside their limits (``checks``), the
peak device memory (``peak_bytes``) and, traced, the span's summary
(``summary``) that the per-layer readers read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

import torch

from benchmark import tracing

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "cbfssm_tpu")
GIB = 2.0 ** 30


def load_json(path):
    with open(path) as f:
        return json.load(f)


def import_attr(dotted: str):
    module, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and mix."""

    def __init__(self, workload: str, spec: dict | None = None, overrides: dict | None = None):
        self.spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
        found = [w for w in self.spec["workloads"] if w["name"] == workload]
        if not found:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = workload
        self.cfg = load_json(BENCH / "configs" / f"{self.workload['config']}.json")
        self.traffic = load_json(BENCH / "traffic" / f"{self.workload['traffic']}.json")
        for section, values in (overrides or {}).items():  # smaller sizes for tests
            if section == "traffic":
                self.traffic = dict(self.traffic, **values)
            else:
                self.cfg[section] = dict(self.cfg[section], **values)
        self.ref = importlib.import_module(f"benchmark.reference.{self.cfg['kind']}")
        self.mix = importlib.import_module(f"benchmark.mixes.{self.traffic['mix']}")

    def metrics(self, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.spec[kind] if self.name in m.get("workloads", [self.name])]


def checks(values: dict, limits: dict) -> dict:
    """Each number compared beside its limit (the configuration's)."""
    return {name: {"value": value, "limit": limits[name]} for name, value in values.items()}


def passed(check: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())


# --- a whole run --------------------------------------------------------------------


def seconds_since_process_start() -> float:
    """Wall time since this process started (``/proc``, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def device_info(cell: Cell, device: str, peak: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(cell.workload["chips"]), "memory_peak_bytes": peak}


def power_limit() -> str | None:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            overrides=None) -> dict:
    """One run; returns the result line's object (``correct`` and the
    numbers compared under ``checks``, which comes last). ``device`` and
    ``overrides`` are for the tests."""
    cell = Cell(workload, overrides=overrides)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res = cell.mix.measure(cell, seed, seconds, trace, device)
    metrics, result_device = {}, device_info(cell, device, res["peak_bytes"])
    out = {"correct": passed(res["checks"]), "attempted": res["attempted"],
           "failed": res["failed"]}
    if trace:
        summary = res["summary"]
        for m in cell.metrics("per_layer"):
            value = metric_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out.update(metrics=metrics, device=result_device, breakdown=tracing.breakdown(summary))
    else:
        for m in cell.metrics("end_to_end"):
            if m["name"] not in res["values"]:
                raise RuntimeError(f"the mix {cell.traffic['mix']!r} measures no {m['name']}")
            metrics[m["name"]] = {"value": res["values"][m["name"]], "unit": m["unit"]}
        out.update(metrics=metrics, device=result_device)
    if device == "cuda":
        print(f"card: {power_limit()}", file=sys.stderr)
    out["checks"] = res["checks"]
    return out
