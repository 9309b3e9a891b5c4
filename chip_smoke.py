#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``cbfssm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU, ``nvcc`` and the repository around this file; it
imports nothing of JAX. Phases, in order; any failure exits non-zero:

1. device: name and power limit (``nvidia-smi``), TF32 off;
2. build: ``nvcc`` builds ``cbfssm_tpu_torch/csrc/gp_predict.cu``;
3. kernel: the fused GP predict kernel against its plain torch version
   at the two RoboMove serving shapes and a ragged one, in float32
   (rtol 2e-5, atol 1e-5) and float64 (rtol 1e-10, atol 1e-12), with
   both times;
4. serving: CBFSSM at the full width of run/run_robomove.py (random
   weights from a seed) answers RoboMove test windows through
   ``BucketedPredictor(buckets=(1, 8, 32))`` + ``MicroBatcher`` from
   several threads and one 40-row request that is chunked; every
   dispatched chunk launches the kernel exactly 399 times (100 blocked
   recognition steps + 299 forward steps). The kernel path is held
   against ``gp_impl='solve_free'`` on one fixed batch and seed: in
   float64 elementwise (rtol 1e-8, atol 1e-10), in float32 on the
   loss-level statistics mse and mean pred_var (rtol 1e-3), since 400
   chained steps amplify float32 rounding. Request latency is timed at
   B = 1 and B = 32 for both paths.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their checks and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEQ_LEN, SEQ_STRIDE = 300, 50
BUCKETS = (1, 8, 32)
STEPS_PER_CHUNK = 2 * 50 + (SEQ_LEN - 1)  # blocked recognition + forward
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def robomove_config(dtype: str, gp_impl: str, ds) -> dict:
    """run/run_robomove.py:26-44 (phase 0) with the port's knobs."""
    import numpy as np

    dim_x = 4
    return {
        "ds": ds, "batch_size": 32, "shuffle": 10000, "dim_x": dim_x,
        "ind_pnt_num": 100, "samples": 50, "learning_rate": 0.01,
        "loss_factors": np.asarray([20.0, 0.0]), "k_factor": 1.0,
        "recog_len": 50, "zeta_pos": 2.0, "zeta_mean": 0.1**2,
        "zeta_var": 0.01**2, "var_x": np.asarray([0.1**2] * dim_x),
        "var_y": np.asarray([1.0**2] * dim_x), "gp_var": 0.1**2,
        "gp_len": 1.0, "dtype": dtype, "gp_impl": gp_impl,
    }


def kernel_inputs(rng, n, m, di, d, dtype, device):
    """Random well-conditioned predict operands (the construction of the
    JAX package's tests/test_pallas_gp.py make_inputs)."""
    import numpy as np
    import torch

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    x = rng.normal(size=(n, di))
    z = rng.normal(size=(m, di))
    inv_ls = 1.0 / rng.uniform(0.5, 2.0, size=di)
    a = rng.normal(size=(m, m))
    kinv = np.linalg.inv(a @ a.T + m * np.eye(m))
    return (t(x), t(z * inv_ls), t(inv_ls), t(0.7), t(kinv),
            t(rng.normal(size=(m, d))), t(rng.uniform(0.01, 0.5, size=(m, d))))


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 could not be turned off")
    return card


def phase_build():
    from cbfssm_tpu_torch.ops import fused_predict as fp

    t0 = time.perf_counter()
    fp._library()
    print(f"build: gp_predict.cu built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)


def phase_kernel():
    import numpy as np
    import torch

    from cbfssm_tpu_torch.ops import fused_predict as fp

    tol = {torch.float32: (2e-5, 1e-5), torch.float64: (1e-10, 1e-12)}
    shapes = {
        "recognition N=12800 M=100 DI=6 D=2": (12800, 100, 6, 2),
        "forward N=1600 M=100 DI=6 D=4": (1600, 100, 6, 4),
        "ragged N=37 M=11 DI=5 D=3": (37, 11, 5, 3),
    }
    rng = np.random.default_rng(0)
    max_err = 0.0
    times = {}
    for dtype, (rtol, atol) in tol.items():
        for label, (n, m, di, d) in shapes.items():
            args = kernel_inputs(rng, n, m, di, d, dtype, DEVICE)
            got = fp.fused_predict(*args)
            torch.cuda.synchronize()
            want = fp.fused_predict_plain(*args)
            torch.cuda.synchronize()
            for name, g, w in zip(("mean", "var"), got, want):
                err = (g - w).abs()
                bad = err > atol + rtol * w.abs()
                if bool(bad.any()):
                    fail(f"kernel {dtype} {label} {name}: {int(bad.sum())} elements "
                         f"outside rtol {rtol} atol {atol}; max abs err {float(err.max()):.3e}")
                if dtype == torch.float32:
                    max_err = max(max_err, float(err.max()))
            k_ms = cuda_ms(lambda: fp.fused_predict(*args), 50)
            p_ms = cuda_ms(lambda: fp.fused_predict_plain(*args), 50)
            times[(dtype, n)] = (k_ms, p_ms)
            print(f"kernel {str(dtype)[6:]} {label}: ok; kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms", flush=True)
    return max_err, times


def phase_serving():
    import numpy as np
    import torch

    from cbfssm_tpu_torch.data import RoboMove
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.serving import BucketedPredictor, CompiledPredictor, MicroBatcher

    ds = RoboMove(SEQ_LEN, SEQ_STRIDE)
    u_all = ds.test_in_batch
    y_all = ds.test_out_batch
    if u_all.shape[0] < 40:
        fail(f"RoboMove gives {u_all.shape[0]} test windows, need 40")

    model = CBFSSM(robomove_config("float32", "pallas", RoboMove), device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    bp = BucketedPredictor(model, params, SEQ_LEN, buckets=BUCKETS)
    bp(u_all[:1], y_all[:1])  # first request: cuBLAS / allocator set-up
    torch.cuda.synchronize()

    def check(out, n, where):
        for name, dim in (("pred_mean", 2), ("pred_var", 2), ("internal_mean", 4),
                          ("internal_var", 4), ("sde", 2)):
            a = getattr(out, name)
            if a.shape != (n, SEQ_LEN, dim):
                fail(f"{where}: {name} has shape {a.shape}, want {(n, SEQ_LEN, dim)}")
            if not np.isfinite(a).all():
                fail(f"{where}: {name} is not finite")
        if not (out.pred_var > 0).all() or not np.isfinite(out.mse):
            fail(f"{where}: non-positive pred_var or non-finite mse")

    # ---- the main path: counts from 0 just before, read just after ----
    fp.fused_predict.launches = 0
    n_req, n_threads = 40, 4
    results = [None] * n_req
    with MicroBatcher(bp, max_batch=32, max_wait_ms=5.0) as mb:
        def client(k):
            futs = [(i, mb.submit(u_all[i], y_all[i])) for i in range(k, n_req, n_threads)]
            for i, f in futs:
                results[i] = f.result(timeout=600)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        if any(th.is_alive() for th in threads):
            fail("MicroBatcher clients did not finish")
        stats = mb.stats()
    chunked = bp(u_all[:40], y_all[:40])  # 40 rows: chunks of 32 and 8
    launches = fp.fused_predict.launches
    for i, out in enumerate(results):
        if out is None:
            fail(f"request {i} got no result")
        check(out, 1, f"MicroBatcher request {i}")
    check(chunked, 40, "chunked request")
    dispatches = stats["batches"] + 2
    if launches != STEPS_PER_CHUNK * dispatches:
        fail(f"kernel launches {launches} != {STEPS_PER_CHUNK} x {dispatches} dispatches")
    print(f"serving: {n_req} MicroBatcher requests from {n_threads} threads in "
          f"{stats['batches']} batches (max {stats['max_batch_seen']}), one 40-row "
          f"request in 2 chunks; {launches} kernel launches = {STEPS_PER_CHUNK} x "
          f"{dispatches} dispatches; outputs finite", flush=True)

    # ---- kernel path against the plain path, same batch and seed ----
    u8, y8 = u_all[:8], y_all[:8]
    outs = {}
    for dtype in ("float64", "float32"):
        for impl in ("pallas", "solve_free"):
            m = CBFSSM(robomove_config(dtype, impl, RoboMove), device=DEVICE)
            out = CompiledPredictor(m, params.to(m.dtype), 8, SEQ_LEN, seed=123)(u8, y8)
            outs[(dtype, impl)] = out.map(lambda a: a.double().cpu().numpy())
    for name in ("pred_mean", "pred_var", "internal_mean", "internal_var"):
        a, b = getattr(outs[("float64", "pallas")], name), getattr(outs[("float64", "solve_free")], name)
        if not np.allclose(a, b, rtol=1e-8, atol=1e-10):
            fail(f"float64 {name}: kernel path vs solve_free differ by {np.abs(a - b).max():.3e}")
    f64_err = max(
        float(np.abs(getattr(outs[("float64", "pallas")], n) - getattr(outs[("float64", "solve_free")], n)).max())
        for n in ("pred_mean", "pred_var")
    )
    stats32 = {}
    for impl in ("pallas", "solve_free"):
        o = outs[("float32", impl)]
        stats32[impl] = (float(o.mse), float(o.pred_var.mean()))
    for i, name in enumerate(("mse", "mean pred_var")):
        a, b = stats32["pallas"][i], stats32["solve_free"][i]
        if abs(a - b) > 1e-3 * abs(b):
            fail(f"float32 {name}: kernel path {a!r} vs solve_free {b!r}")
    print(f"parity: float64 outputs max abs diff {f64_err:.3e} (rtol 1e-8); float32 "
          f"kernel (mse, mean pred_var) {stats32['pallas']} vs solve_free "
          f"{stats32['solve_free']} (rtol 1e-3)", flush=True)

    # ---- request latency, float32, both paths ----
    latency = {}
    for impl in ("pallas", "solve_free"):
        m = CBFSSM(robomove_config("float32", impl, RoboMove), device=DEVICE)
        pred = BucketedPredictor(m, params, SEQ_LEN, buckets=BUCKETS)
        for b in (1, 32):
            pred(u_all[:b], y_all[:b])
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                pred(u_all[:b], y_all[:b])
                times.append(1e3 * (time.perf_counter() - t0))
            latency[(impl, b)] = sorted(times)[len(times) // 2]
            print(f"latency gp_impl={impl} B={b}: median {latency[(impl, b)]:.2f} ms "
                  f"over 5 requests ({', '.join(f'{t:.2f}' for t in times)})", flush=True)
    return launches


def main() -> None:
    if not (ROOT / "cbfssm_tpu_torch" / "__init__.py").is_file():
        fail("cbfssm_tpu_torch/ is not beside chip_smoke.py; run from the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_device()
    phase_build()
    max_err, times = phase_kernel()
    launches = phase_serving()
    if "jax" in sys.modules:
        fail("jax was imported")
    k_ms, p_ms = times[(torch.float32, 12800)]
    print(json.dumps({"kernels": [{
        "name": "gp_predict",
        "route": "cuda",
        "source": "cbfssm_tpu_torch/csrc/gp_predict.cu",
        "replaces": "cbfssm_tpu/ops/pallas/gp_predict.py:79",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
