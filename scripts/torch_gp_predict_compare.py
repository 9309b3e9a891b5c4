"""Two builds of the GP-predict CUDA source side by side on the card.

    python3 scripts/torch_gp_predict_compare.py [--timing-only] [--json=PATH]
        before=OLD.cu after=cbfssm_tpu_torch/csrc/gp_predict.cu

(one command line).

Each ``label=path`` source is compiled with ``ops/_build.py``'s flags
plus ``-Xptxas -v`` into ``build/compare/<label>.so`` (all builds started
together) and loaded with ``ctypes``; the sources must share the C
entry points of ``csrc/gp_predict.cu``. For each build it prints:

- ptxas's registers, spills and stack of each kernel instantiation, and
  the count of ``HMMA`` / ``DMMA`` / ``FFMA`` / ``DFMA`` instructions in
  its SASS (``cuobjdump -sass``);
- ``gp_predict_max_m`` at the widths ``chip_smoke.py``'s build phase
  prints;
- at every timed shape, the largest error against the plain version
  (float32 rtol 2e-5 / atol 1e-5, float64 rtol 1e-10 / atol 1e-12; it
  fails outside them) and the device time by CUDA-graph replay
  (``utils/kernel_timing.graph_replay_ms``), the builds in turn and back
  (a, b, b, a for two), each build's figure the mean of its two;
- on an ill-conditioned kinv (``kernel_timing.ill_conditioned_inputs``:
  the jittered RBF Gram of 100 inducing points, jitter 1e-6), the
  float32 build's largest error in mean, var, kmn and w against a
  float64 plain truth on the same float32 operands, beside the float32
  plain version's;
- whether a row's result depends on where it is computed: rows of a
  12,800-row launch against the same rows launched alone (4 rows, 52
  rows), and one lane against the single entry, bit for bit.

Writes everything as JSON to ``build/compare/gp_predict_compare.json``
(or ``--json=PATH``) and prints the card's name and power limit first. Needs the card, ``nvcc`` and
``cuobjdump``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from cbfssm_tpu_torch.ops import _build  # noqa: E402
from cbfssm_tpu_torch.ops import fused_predict as fp  # noqa: E402
from cbfssm_tpu_torch.utils.kernel_timing import (FILTER_SHAPES, MODEL_SHAPES,  # noqa: E402
                                                  graph_replay_ms, ill_conditioned_inputs,
                                                  kernel_inputs)

OUT = ROOT / "build" / "compare"
TOL = {torch.float32: (2e-5, 1e-5), torch.float64: (1e-10, 1e-12)}
# (label, L or None, N, M, DI, D, dtype): the main-path shapes, the B = 1
# serving shapes, the fleet, the Voliro and Sarcos shapes, the lanes
TIMED = [
    ("recognition", None, 12800, 100, 6, 2, torch.float32),
    ("forward", None, 1600, 100, 6, 4, torch.float32),
    ("serving B=1 recognition", None, 400, 100, 6, 2, torch.float32),
    ("serving B=1 forward", None, 50, 100, 6, 4, torch.float32),
    ("fleet 1024", None, *FILTER_SHAPES["fleet 1024"], torch.float32),
    *((name, None, *shape, torch.float32) for name, shape in MODEL_SHAPES.items()),
    ("lanes sarcos recognition", 5, 1800, 100, 21, 7, torch.float32),
    ("lanes robomove recognition", 4, 12800, 100, 6, 2, torch.float32),
    ("recognition", None, 12800, 100, 6, 2, torch.float64),
    ("forward", None, 1600, 100, 6, 4, torch.float64),
]
CAP_WIDTHS = ((6, 4), (6, 2), (12, 3), (19, 6), (21, 7), (21, 14))
ENTRIES = [f"gp_predict{r}{ln}{s}" for r in ("", "_residuals") for ln in ("", "_lanes")
           for s in ("_f32", "_f64")]
INSTANTIATIONS = {"IfLb0E": "float, value", "IfLb1E": "float, residuals",
                  "IdLb0E": "double, value", "IdLb1E": "double, residuals"}


def build_all(sources: dict) -> dict:
    """Compile every source at once; returns {label: (library path,
    ptxas output)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        lib = OUT / f"{label}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {label}:\n{out}")
        built[label] = (lib, out)
    return built


def ptxas_summary(log: str) -> dict:
    """{instantiation: 'registers, spills, stack'} from ptxas -v."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = next((v for k, v in INSTANTIATIONS.items() if k in m.group(1)), None)
        elif current and ("Used" in line or "spill" in line or "stack frame" in line):
            out[current] = (out.get(current, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def sass_counts(lib: Path) -> dict:
    """{instantiation: {opcode: count}} from cuobjdump -sass."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = next((v for k, v in INSTANTIATIONS.items() if k in m.group(1)), None)
            if current:
                out[current] = {op: 0 for op in ("HMMA", "DMMA", "FFMA", "DFMA")}
        elif current:
            for op in out[current]:
                if re.search(rf"\b{op}\b", line):
                    out[current][op] += 1
    return out


class Lib:
    """One built library, its entries declared as ``fused_predict._library``
    declares them."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        for name in ENTRIES:
            fn = getattr(self.lib, name)
            n_ptr = 11 if "residuals" in name else 9
            n_int = 5 if "lanes" in name else 4
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        self.lib.gp_predict_max_m.argtypes = [ctypes.c_int] * 3
        self.lib.gp_predict_max_m.restype = ctypes.c_int

    def call(self, args, residuals: bool, outs=None):
        """Launch on the current stream; returns (mean, var[, kmn, w])."""
        x = args[0]
        lanes = x.dim() == 3
        lead = tuple(x.shape[:1]) if lanes else ()
        n, m, d = x.shape[-2], args[1].shape[-2], args[5].shape[-1]
        di = x.shape[-1]
        if outs is None:
            shapes = [(n, d), (n, d), (n, m), (n, m)][:4 if residuals else 2]
            outs = [torch.empty(lead + s, dtype=x.dtype, device=x.device) for s in shapes]
        name = ("gp_predict_residuals" if residuals else "gp_predict") + (
            "_lanes" if lanes else "") + ("_f32" if x.dtype == torch.float32 else "_f64")
        err = getattr(self.lib, name)(*(t.data_ptr() for t in (*args, *outs)), *lead, n, m, di,
                                      d, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} failed with CUDA error {err}")
        return outs


def plain(args, residuals: bool):
    mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
    return (mean, var, kmn, w) if residuals else (mean, var)


def max_err(got, want, dtype, checked: bool = True) -> float:
    rtol, atol = TOL[dtype]
    worst = 0.0
    for g, w in zip(got, want):
        e = (g - w).abs()
        if checked and bool((e > atol + rtol * w.abs()).any()):
            raise SystemExit(f"outside rtol {rtol} atol {atol}: max abs err {float(e.max()):.3e}")
        worst = max(worst, float(e.max()))
    return worst


def shape_args(rng, lanes, n, m, di, d, dtype):
    if lanes is None:
        return kernel_inputs(rng, n, m, di, d, dtype, "cuda")
    per = [kernel_inputs(rng, n, m, di, d, dtype, "cuda") for _ in range(lanes)]
    return tuple(torch.stack(ts) for ts in zip(*per))


def main() -> None:
    opts = [a for a in sys.argv[1:] if a.startswith("--")]
    sources = dict(a.split("=", 1) for a in sys.argv[1:] if not a.startswith("--"))
    if not sources:
        sys.exit(__doc__)
    # --timing-only: time the builds at the first two shapes of TIMED
    # (both dtypes) and check nothing, for builds that are not meant to
    # be right (a phase left out to see what it costs)
    timing_only = "--timing-only" in opts
    json_path = next((Path(o.split("=", 1)[1]) for o in opts if o.startswith("--json=")),
                     OUT / "gp_predict_compare.json")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_all(sources)
    libs = {label: Lib(path) for label, (path, _) in built.items()}
    report = {"card": card, "builds": {}, "timed": [], "ill_conditioned": {}, "placement": {}}
    for label, (path, log) in built.items():
        info = {"ptxas": ptxas_summary(log), "sass": sass_counts(path),
                "max_m": {f"{'f64' if f64 else 'f32'} DI={di} D={d}":
                          libs[label].lib.gp_predict_max_m(f64, di, d)
                          for f64 in (0, 1) for di, d in CAP_WIDTHS}}
        report["builds"][label] = info
        print(f"{label}: {json.dumps(info)}", flush=True)

    order = list(libs) + list(libs)[::-1]
    timed = [t for t in TIMED if t[0] in ("recognition", "forward")] if timing_only else TIMED
    for name, lanes, n, m, di, d, dtype in timed:
        args = shape_args(np.random.default_rng(n), lanes, n, m, di, d, dtype)
        for residuals in (False, True):
            want = plain(args, residuals)
            row = {"shape": f"{name} {str(dtype)[6:]} L={lanes} N={n} M={m} DI={di} D={d}",
                   "kernel": "residuals" if residuals else "value"}
            for label, lib in libs.items():
                got = lib.call(args, residuals)
                torch.cuda.synchronize()
                row[f"err_{label}"] = max_err(got, want, dtype, checked=not timing_only)
            times = {label: [] for label in libs}
            for label in order:
                outs = libs[label].call(args, residuals)
                times[label].append(graph_replay_ms(
                    lambda lib=libs[label], o=outs: lib.call(args, residuals, o)))
            for label, ts in times.items():
                row[f"us_{label}"] = 1e3 * sum(ts) / len(ts)
                row[f"us_{label}_runs"] = [1e3 * t for t in ts]
            report["timed"].append(row)
            print(json.dumps(row), flush=True)

    if timing_only:
        write_report(report, json_path)
        return
    args, cond = ill_conditioned_inputs(torch.float32, "cuda")
    truth = plain(tuple(a.double() for a in args), True)
    report["ill_conditioned"]["cond"] = cond
    for label, fn in [("plain", lambda: plain(args, True)),
                      *((lb, lambda lib=lib: lib.call(args, True)) for lb, lib in libs.items())]:
        got = fn()
        torch.cuda.synchronize()
        report["ill_conditioned"][label] = {
            nm: float((g.double() - t).abs().max())
            for nm, g, t in zip(("mean", "var", "kmn", "w"), got, truth)}
    print(json.dumps(report["ill_conditioned"]), flush=True)

    for label, lib in libs.items():
        same = {}
        for dtype in (torch.float32, torch.float64):
            args = kernel_inputs(np.random.default_rng(7), 12800, 100, 6, 2, dtype, "cuda")
            for residuals in (False, True):
                whole = lib.call(args, residuals)
                for r0, rows in ((0, 4), (5200, 4), (6000, 52), (12796, 4)):
                    part = lib.call((args[0][r0:r0 + rows].contiguous(), *args[1:]), residuals)
                    torch.cuda.synchronize()
                    kind = "residuals" if residuals else "value"
                    key = f"{str(dtype)[6:]} {kind} rows {r0}+{rows}"
                    same[key] = all(torch.equal(w[r0:r0 + rows], p) for w, p in zip(whole, part))
                one = lib.call(tuple(a[None] for a in args), residuals)
                torch.cuda.synchronize()
                same[f"{str(dtype)[6:]} {'residuals' if residuals else 'value'} one lane"] = all(
                    torch.equal(w, o[0]) for w, o in zip(whole, one))
        report["placement"][label] = same
        print(f"{label} placement: {json.dumps(same)}", flush=True)

    write_report(report, json_path)


def write_report(report: dict, dest: Path) -> None:
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(report, indent=1))
    print(f"wrote {dest}", flush=True)


if __name__ == "__main__":
    main()
