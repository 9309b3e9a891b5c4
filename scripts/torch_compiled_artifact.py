"""Load time and request time of the port's compiled predictor artifact.

    python scripts/torch_compiled_artifact.py [--seq 300] [--inductor-defaults] [--out FILE]

Exports the RoboMove CBFSSM predictor (phase-0 width: dim_x 4, M 100,
S 50, recog_len 50; float32, ``gp_impl='pallas'``, seed-0 init) at
B = 1 and each ``--seq`` length. Then, for the compile options of
``export.COMPILE_OPTIONS`` (and, with ``--inductor-defaults``, also for
Inductor's defaults, which time kernel configurations on the card), it
loads the artifact in two new processes on one new compile-cache
directory (``CBFSSM_XLA_CACHE``):

- cold: ``ExportedPredictor(path)`` (``torch.export.load``, the device
  pass, the compile and one call): its seconds and Inductor's cache
  counters;
- warm: the same on the filled cache, then in that process: the
  ``gp_predict`` launches of one call against the program's
  ``cbfssm_torch::gp_predict`` nodes; the replies of the compiled
  artifact, the uncompiled program and the live ``CompiledPredictor``
  (the same seed-0 params and draws) against each other (the
  uncompiled program bitwise, the compiled one at rtol 2e-5 / atol
  1e-6); B = 1 request ms (host clock to the synchronised reply) of the
  three, in turns; one request of each under ``torch.profiler``: its
  device kernels and their summed time.

It runs on the card (``--device cpu --tiny`` rehearses it at S 2, M 5 on
the CPU). The JSON goes to ``--out`` after each load pair; the card's
name and power limit are printed with it. Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card_name() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no nvidia-smi"
    except (OSError, IndexError):
        return "no nvidia-smi"


def model_and_params(device: str, tiny: bool):
    import torch

    from cbfssm_tpu_torch import run_robomove
    from cbfssm_tpu_torch.models import CBFSSM

    overrides = {"dtype": "float32", "gp_impl": "pallas"}
    if tiny:
        overrides.update(samples=2, ind_pnt_num=5)
    model = CBFSSM(run_robomove.model_config(0, overrides), device=device)
    return model, model.init(torch.Generator(device=device).manual_seed(0))


def sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def profile_call(fn, device) -> dict:
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        fn()
        sync(device)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    count, busy = collections.Counter(), collections.Counter()
    for e in kernels:
        count[e.name] += 1
        busy[e.name] += e.time_range.elapsed_us() / 1e3
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    return {"kernels": len(kernels), "busy_ms": sum(busy.values()),
            "top": [[name[:100], count[name], ms] for name, ms in top]}


def compare(outs, refs, fields) -> dict:
    """Max abs difference and the largest |a - b| / (1e-6 + 2e-5 |b|) (at
    most 1 within rtol 2e-5 / atol 1e-6)."""
    return {"max_abs": max(float((outs[f] - refs[f]).abs().max()) for f in fields),
            "tol_ratio": max(float(((outs[f] - refs[f]).abs() / (1e-6 + 2e-5 * refs[f].abs()))
                                   .max()) for f in fields)}


def child(path: str, device: str, seq: int, tiny: bool, defaults: bool, measure: bool,
          requests: int) -> dict:
    """One process's load of the artifact, and with ``measure`` the
    checks and times of the module docstring."""
    import statistics
    import time

    import numpy as np
    import torch
    from torch._dynamo.utils import counters

    from cbfssm_tpu_torch import export
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.serving import CompiledPredictor

    if defaults:
        export.COMPILE_OPTIONS = {}
    t0 = time.perf_counter()
    pred = export.ExportedPredictor(path, device=device)
    if device == "cpu":  # a CPU load does not compile: as a load on the card
        pred.compiled = export._compile_program(pred.program, pred._zero_args())
    sync(device)
    res = {"load_s": time.perf_counter() - t0,
           "counters": {k: dict(counters[k]) for k in ("inductor", "aot_autograd")}}
    if not measure:
        return res
    model, params = model_and_params(device, tiny)
    live = CompiledPredictor(model, params, 1, seq)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(1, seq, model.dim_u)).astype(np.float32)
    y = rng.normal(size=(1, seq, model.dim_y)).astype(np.float32)
    kw = dict(dtype=pred.dtype, device=pred.device)

    def uncompiled():
        with torch.no_grad():
            return pred.program(pred._params, torch.as_tensor(u, **kw), torch.as_tensor(y, **kw),
                                tuple(pred._draw_noise(3)))

    calls = {"compiled": lambda: pred(u, y, seed=3), "uncompiled": uncompiled,
             "live": lambda: live(u, y, seed=3)}
    outs = {}
    for name, fn in calls.items():  # warm-up: cuBLAS, the allocator
        outs[name] = fn()
        sync(device)
    fields = list(pred.meta["output_fields"])
    outs["live"] = {f: getattr(outs["live"], f) for f in fields}
    plain = fp.fused_predict_plain
    if device == "cpu":  # the op's CPU body: count its calls as launches
        def counted(*a):
            fp.fused_predict.launches += 1
            return plain(*a)
        fp.fused_predict_plain = counted
    fp.fused_predict.launches = 0
    calls["compiled"]()
    sync(device)
    fp.fused_predict_plain = plain
    res["launches_one_call"] = fp.fused_predict.launches
    res["nodes"] = export.gp_predict_nodes(pred.program)
    res["graph_nodes"] = len(pred.program.graph.nodes)
    res["uncompiled_bitwise_live"] = all(torch.equal(outs["uncompiled"][f], outs["live"][f])
                                         for f in fields)
    res["compiled_vs_live"] = compare(outs["compiled"], outs["live"], fields)
    res["compiled_vs_uncompiled"] = compare(outs["compiled"], outs["uncompiled"], fields)
    times = {name: [] for name in calls}
    for r in range(requests):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            sync(device)
            t1 = time.perf_counter()
            calls[name]()
            sync(device)
            times[name].append(1e3 * (time.perf_counter() - t1))
    res["request_ms"] = times
    res["request_ms_median"] = {k: statistics.median(v) for k, v in times.items()}
    res["profile"] = {name: profile_call(fn, device) for name, fn in calls.items()}
    res["ok"] = (res["uncompiled_bitwise_live"] and res["launches_one_call"] == res["nodes"]
                 and res["compiled_vs_live"]["tol_ratio"] <= 1
                 and res["compiled_vs_uncompiled"]["tol_ratio"] <= 1)
    return res


def run_child(args, path: str, seq: int, cache: str, defaults: bool, measure: bool) -> dict:
    env = dict(os.environ, CBFSSM_XLA_CACHE=cache)
    env.pop("TORCHINDUCTOR_CACHE_DIR", None)
    env.pop("TRITON_CACHE_DIR", None)
    cmd = [sys.executable, __file__, "--child", path, "--seq", str(seq), "--device",
           args.device, "--requests", str(args.requests)]
    cmd += ["--tiny"] * args.tiny + ["--inductor-defaults"] * defaults + ["--measure"] * measure
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=3000)
    if p.returncode != 0:
        raise RuntimeError(f"load subprocess failed: {p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, action="append")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--inductor-defaults", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.device, args.seq[0], args.tiny,
                               args.inductor_defaults, args.measure, args.requests)))
        return

    import time

    from cbfssm_tpu_torch.export import save_exported_predictor

    card = card_name() if args.device == "cuda" else "cpu"
    print(card, flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    results, ok = [], True
    variants = [False] + [True] * args.inductor_defaults
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for seq in args.seq or [300]:
            model, params = model_and_params(args.device, args.tiny)
            path = os.path.join(tmp, f"predictor_{seq}")
            t0 = time.perf_counter()
            save_exported_predictor(path, model, params, 1, seq)
            export_s = time.perf_counter() - t0
            for defaults in variants:
                cache = os.path.join(tmp, f"cache_{seq}_{int(defaults)}")
                cold = run_child(args, path, seq, cache, defaults, measure=False)
                warm = run_child(args, path, seq, cache, defaults, measure=True)
                res = {"seq": seq, "inductor_defaults": defaults, "export_s": export_s,
                       "cold": cold, "warm": warm, "card": card}
                results.append(res)
                ok &= warm["ok"]
                med = warm["request_ms_median"]
                print(f"seq {seq}, {'Inductor defaults' if defaults else 'COMPILE_OPTIONS'}: "
                      f"{warm['nodes']} gp_predict nodes of {warm['graph_nodes']}; export "
                      f"{export_s:.2f} s; load cold {cold['load_s']:.2f} s, warm "
                      f"{warm['load_s']:.2f} s (new processes); launches of one call "
                      f"{warm['launches_one_call']}; B=1 request ms (median of {args.requests}, "
                      f"in turns) compiled {med['compiled']:.2f}, uncompiled "
                      f"{med['uncompiled']:.2f}, live {med['live']:.2f}; kernels per request "
                      f"{ {k: v['kernels'] for k, v in warm['profile'].items()} }; device ms "
                      f"{ {k: round(v['busy_ms'], 3) for k, v in warm['profile'].items()} }; "
                      f"uncompiled bitwise live {warm['uncompiled_bitwise_live']}; compiled vs "
                      f"live {warm['compiled_vs_live']}, vs uncompiled "
                      f"{warm['compiled_vs_uncompiled']}; {card}", flush=True)
                print(f"  cache counters cold {cold['counters']}, warm {warm['counters']}",
                      flush=True)
                if args.out:  # after each pair: a later one may run out of time
                    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
