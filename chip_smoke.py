#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``cbfssm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU, ``nvcc`` and the repository around this file; it
imports nothing of JAX. Phases, in order; any failure exits non-zero:

1. device: name and power limit (``nvidia-smi``), TF32 off;
2. build: ``nvcc`` builds ``cbfssm_tpu_torch/csrc/gp_predict.cu`` (both
   kernels, ``gp_predict`` and ``gp_predict_residuals``);
3. kernel: ``gp_predict`` against its plain torch version at the two
   RoboMove shapes and a ragged one, in float32 (rtol 2e-5, atol 1e-5)
   and float64 (rtol 1e-10, atol 1e-12); times: the kernel's device time
   per launch (a CUDA graph of 20 back-to-back launches replayed 10
   times, ``kernel_timing.graph_replay_ms``) at the two RoboMove shapes,
   and 50 eager back-to-back calls of the kernel and of the plain
   version (host issue included);
3b. residual kernel and gradient: ``gp_predict_residuals`` against
   ``fused_predict_residuals_plain`` (mean, var, kmn, w) at the same
   shapes and tolerances, timed the same way; and in float64 the gradients
   of ``FusedPredict`` (kernel forward, analytic backward) against
   torch autograd of ``fused_predict_plain`` for all seven inputs
   (rtol 1e-8, atol 1e-10 times the largest entry);
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
   B = 1 and B = 32 for both paths. Serving launches
   ``gp_predict_residuals`` 0 times (it runs under inference mode);
5. training: ``Trainer(model, dir, seed=0).train(RoboMove(300, 50),
   epochs=1)`` at the phase-0 config of run/run_robomove.py, float32,
   ``gp_impl='pallas'``: 16 Adam steps (each launches
   ``gp_predict_residuals`` 399 times) and 3 test batches (each launches
   ``gp_predict`` 399 times); finite losses, both checkpoints written and
   restored. Then, on one fixed batch of 32 windows and one
   ``RolloutNoise``, the loss and the gradient of every parameter leaf
   under ``'pallas'`` and ``'solve_free'``: float64 loss at rtol 1e-10,
   each leaf's gradient at rtol 1e-6 with atol 1e-8 times the leaf's
   largest entry; float32 loss at rtol 1e-3 and global gradient norm at
   rtol 1e-2 (399 chained steps amplify float32 rounding). Last, the ms
   per optimizer step of ``Trainer.train`` (median of steps 2-16) and
   the peak allocated device memory of the epoch, for the main-path
   epoch and one more epoch under ``'solve_free'`` (B = 32, float32),
   and one further step of each under ``torch.profiler``: device
   kernels, their summed time, the busy share and the largest kernels.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the card, and the line before that lists the kernels with their
checks and times: ``ms`` is the graph-replayed device time at the
recognition shape (float32, N = 12,800), ``ms_n1600`` the same at the
forward shape (N = 1,600), each beside its bound (``bound_ms``,
``bound_ms_n1600``); ``eager_ms`` is the back-to-back figure and
``device_ms_f64`` has the same device times in float64.
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
TRAIN_WINDOWS, TEST_WINDOWS, BATCH = 495, 95, 32  # RoboMove(300, 50)
DEVICE = "cuda"
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): CUDA-core FP32
# and FP64 (the kernels use no tensor cores) and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
SHAPES = {
    "recognition N=12800 M=100 DI=6 D=2": (12800, 100, 6, 2),
    "forward N=1600 M=100 DI=6 D=4": (1600, 100, 6, 4),
    "ragged N=37 M=11 DI=5 D=3": (37, 11, 5, 3),
}
TIMED_N = (12800, 1600)  # the RoboMove shapes, timed by graph replay


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def config(dtype: str, gp_impl: str) -> dict:
    """The phase-0 RoboMove config of the port's run script."""
    from cbfssm_tpu_torch import run_robomove

    return run_robomove.model_config(0, {"dtype": dtype, "gp_impl": gp_impl})


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def bound(n, m, di, d, dtype: str, residuals: bool):
    """(ms, 'operations' | 'bytes'): the least time the card could take
    for one predict. Operations per row: the cross-Gram 2*M*DI, the
    M-long epilogues (~9 M), w = kmn @ kinv 2*M^2, mean and the variance
    product 4*M*D; bytes: each input read once, each output written
    once (with residuals also kmn and w, [N, M] each)."""
    itemsize = 4 if dtype == "float32" else 8
    ops = n * (2 * m * m + 2 * m * di + 4 * m * d + 9 * m + 3 * di)
    elems = n * di + m * di + di + 1 + m * m + 2 * m * d + 2 * n * d
    if residuals:
        elems += 2 * n * m
    t_ops = ops / PEAK_FLOPS[dtype]
    t_bytes = elems * itemsize / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def fmt_ms(ms) -> str:
    return "not timed" if ms is None else f"{ms:.5f} ms"


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
    from cbfssm_tpu_torch.utils.kernel_timing import graph_replay_ms, kernel_inputs

    tol = {torch.float32: (2e-5, 1e-5), torch.float64: (1e-10, 1e-12)}
    rng = np.random.default_rng(0)
    max_err = 0.0
    times = {}
    for dtype, (rtol, atol) in tol.items():
        for label, (n, m, di, d) in SHAPES.items():
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
            dev_ms = graph_replay_ms(lambda: fp.fused_predict(*args)) if n in TIMED_N else None
            times[(dtype, n)] = (dev_ms, k_ms, p_ms)
            print(f"kernel {str(dtype)[6:]} {label}: ok; device {fmt_ms(dev_ms)} (graph "
                  f"replay), eager kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)
    return max_err, times


def phase_residual_kernel():
    """gp_predict_residuals against its plain version, and the gradients
    of FusedPredict against autograd of the plain predict."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.utils.kernel_timing import graph_replay_ms, kernel_inputs

    tol = {torch.float32: (2e-5, 1e-5), torch.float64: (1e-10, 1e-12)}
    rng = np.random.default_rng(1)
    max_err, grad_err = 0.0, 0.0
    times = {}
    for dtype, (rtol, atol) in tol.items():
        for label, (n, m, di, d) in SHAPES.items():
            args = kernel_inputs(rng, n, m, di, d, dtype, DEVICE)
            got = fp.fused_predict_residuals(*args)
            sync()
            mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
            for name, g, ref in zip(("mean", "var", "kmn", "w"), got, (mean, var, kmn, w)):
                err = (g - ref).abs()
                bad = err > atol + rtol * ref.abs()
                if bool(bad.any()):
                    fail(f"residual kernel {dtype} {label} {name}: {int(bad.sum())} elements "
                         f"outside rtol {rtol} atol {atol}; max abs err {float(err.max()):.3e}")
                if dtype == torch.float32:
                    max_err = max(max_err, float(err.max()))
            k_ms = cuda_ms(lambda: fp.fused_predict_residuals(*args), 50)
            p_ms = cuda_ms(lambda: fp.fused_predict_residuals_plain(*args), 50)
            dev_ms = (graph_replay_ms(lambda: fp.fused_predict_residuals(*args))
                      if n in TIMED_N else None)
            times[(dtype, n)] = (dev_ms, k_ms, p_ms)
            print(f"residual kernel {str(dtype)[6:]} {label}: ok; device {fmt_ms(dev_ms)} "
                  f"(graph replay), eager kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms",
                  flush=True)
            if dtype != torch.float64:
                continue
            leaves = [a.clone().requires_grad_(True) for a in args]
            cts = (torch.randn(mean.shape, generator=torch.Generator(DEVICE).manual_seed(n),
                               dtype=dtype, device=DEVICE),
                   torch.randn(var.shape, generator=torch.Generator(DEVICE).manual_seed(n + 1),
                               dtype=dtype, device=DEVICE))
            got_g = torch.autograd.grad(fp.FusedPredict.apply(*leaves), leaves, cts)
            want_g = torch.autograd.grad(fp.fused_predict_plain(*leaves), leaves, cts)
            for name, g, ref in zip(("x", "zs", "inv_ls", "kvar", "kinv", "alpha", "var_q"),
                                    got_g, want_g):
                scale = float(ref.abs().max())
                err = (g - ref).abs()
                if bool((err > 1e-10 * scale + 1e-8 * ref.abs()).any()):
                    fail(f"FusedPredict gradient {label} d_{name}: max abs err "
                         f"{float(err.max()):.3e} (largest entry {scale:.3e}); rtol 1e-8")
                grad_err = max(grad_err, float(err.max()) / max(scale, 1e-300))
            print(f"gradient float64 {label}: FusedPredict vs autograd of the plain predict, "
                  f"7 inputs ok (rtol 1e-8)", flush=True)
    print(f"gradient: largest error relative to the largest entry {grad_err:.3e}", flush=True)
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

    model = CBFSSM(config("float32", "pallas"), device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    bp = BucketedPredictor(model, params, SEQ_LEN, buckets=BUCKETS)
    bp(u_all[:1], y_all[:1])  # first request: cuBLAS / allocator set-up
    sync()

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
    fp.fused_predict_residuals.launches = 0
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
    residual_launches = fp.fused_predict_residuals.launches
    if residual_launches != 0:
        fail(f"serving launched gp_predict_residuals {residual_launches} times, want 0")
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
            m = CBFSSM(config(dtype, impl), device=DEVICE)
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
        m = CBFSSM(config("float32", impl), device=DEVICE)
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


def timed_train(model, model_dir, ds):
    """``Trainer(model, model_dir, seed=0).train(ds, epochs=1)`` with each
    ``train_step`` timed on the host clock, each ending in a device
    sync. Returns the trainer, the step times (ms), the peak allocated
    device memory of the epoch and the last step's arguments."""
    import torch

    from cbfssm_tpu_torch.training import Trainer

    trainer = Trainer(model, model_dir, seed=0)
    step, times, last = trainer.train_step, [], []

    def timed_step(*args):
        t0 = time.perf_counter()
        out = step(*args)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        last[:] = [args]
        return out

    trainer.train_step = timed_step
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    trainer.train(ds, epochs=1)
    sync()
    del trainer.train_step
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    return trainer, times, peak, last[0]


def profile_step(trainer, args, label: str, step_ms: float, card: str, top: int = 8):
    """One more ``train_step`` on ``args`` under ``torch.profiler``: its
    device kernels, their summed time (one stream, so the busy time),
    the busy share of the median step ``step_ms`` and the largest
    kernels by device time."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(*args)
        sync()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(v[1] for v in by_name.values())
    print(f"profile {label}: device kernel time {busy_ms:.2f} ms in {len(kernels)} kernels; "
          f"busy share of the median step {100 * busy_ms / step_ms:.1f} %; {card}", flush=True)
    for name, (count, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {ms:9.3f} ms  {count:6d} x  {name[:110]}", flush=True)


def loss_and_grads(model, params, u, y, noise):
    """(loss, [grad of each leaf]) of one batch."""
    import torch

    leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
    loss, _ = model.loss(type(params).from_tensors(leaves), u, y, condition=True, noise=noise)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def phase_training(card: str):
    """One full-width RoboMove epoch through Trainer (the main path),
    then gradient parity and step times of both gp_impl values."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from cbfssm_tpu_torch.data import RoboMove
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.training import Trainer, checkpoint

    ds = RoboMove(SEQ_LEN, SEQ_STRIDE)
    n_train, n_test = ds.train_in_batch.shape[0], ds.test_in_batch.shape[0]
    if (n_train, n_test) != (TRAIN_WINDOWS, TEST_WINDOWS):
        fail(f"RoboMove gives {n_train}/{n_test} windows, want {TRAIN_WINDOWS}/{TEST_WINDOWS}")
    steps, test_batches = -(-n_train // BATCH), -(-n_test // BATCH)
    model = CBFSSM(config("float32", "pallas"), device=DEVICE)

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
        # ---- the main path: counts from 0 just before, read just after ----
        fp.fused_predict.launches = 0
        fp.fused_predict_residuals.launches = 0
        t0 = time.perf_counter()
        trainer, times, peak, last_args = timed_train(model, model_dir, ds)
        epoch_s = time.perf_counter() - t0
        residual_launches = fp.fused_predict_residuals.launches
        launches = fp.fused_predict.launches
        if not (np.isfinite(trainer.train_all).all() and np.isfinite(trainer.test_all).all()):
            fail(f"non-finite losses: train {trainer.train_all}, test {trainer.test_all}")
        if residual_launches != steps * STEPS_PER_CHUNK:
            fail(f"gp_predict_residuals launches {residual_launches} != {steps} steps x "
                 f"{STEPS_PER_CHUNK}")
        if launches != test_batches * STEPS_PER_CHUNK:
            fail(f"gp_predict launches {launches} != {test_batches} test batches x "
                 f"{STEPS_PER_CHUNK}")
        for name in (checkpoint.BEST, checkpoint.LAST):
            if not checkpoint.exists(f"{model_dir}/{name}"):
                fail(f"{name} was not written")
        restored = Trainer(model, model_dir, seed=0).restore(checkpoint.LAST)
        for a, b in zip(restored.tensors(), trainer.params.tensors()):
            if not torch.equal(a.detach(), b.detach()):
                fail("model.ckpt does not restore the trained params")
        Trainer(model, model_dir, seed=0).restore(checkpoint.BEST)
    print(f"training: 1 epoch of {steps} Adam steps + {test_batches} test batches in "
          f"{epoch_s:.2f} s; train loss {trainer.train_all[0]!r}, test loss "
          f"{trainer.test_all[0]!r}; gp_predict_residuals launches {residual_launches} = "
          f"{steps} x {STEPS_PER_CHUNK}, gp_predict launches {launches} = {test_batches} x "
          f"{STEPS_PER_CHUNK}; best.ckpt and model.ckpt restore", flush=True)

    # ---- gradient parity of the two gp_impl paths, one fixed batch ----
    params0 = trainer.params.detach()
    u = torch.as_tensor(ds.train_in_batch[:BATCH], device=DEVICE)
    y = torch.as_tensor(ds.train_out_batch[:BATCH], device=DEVICE)
    res = {}
    for dtype in ("float64", "float32"):
        for impl in ("pallas", "solve_free"):
            m = CBFSSM(config(dtype, impl), device=DEVICE)
            noise = m.draw_noise(torch.Generator(DEVICE).manual_seed(7), SEQ_LEN, BATCH)
            res[(dtype, impl)] = loss_and_grads(m, params0.to(m.dtype), u, y, noise)
    (l_p, g_p), (l_s, g_s) = res[("float64", "pallas")], res[("float64", "solve_free")]
    if abs(float(l_p) - float(l_s)) > 1e-10 * abs(float(l_s)):
        fail(f"float64 loss: pallas {float(l_p)!r} vs solve_free {float(l_s)!r}")
    worst = 0.0
    for k, (a, b) in enumerate(zip(g_p, g_s)):
        scale = float(b.abs().max())
        err = (a - b).abs()
        if bool((err > 1e-6 * b.abs() + 1e-8 * scale).any()):
            fail(f"float64 gradient of leaf {k}: max abs err {float(err.max()):.3e}, largest "
                 f"entry {scale:.3e} (rtol 1e-6, atol 1e-8 x largest)")
        worst = max(worst, float(err.max()) / max(scale, 1e-300))
    (l_p32, g_p32), (l_s32, g_s32) = res[("float32", "pallas")], res[("float32", "solve_free")]
    norm_p = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in g_p32)))
    norm_s = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in g_s32)))
    if abs(float(l_p32) - float(l_s32)) > 1e-3 * abs(float(l_s32)):
        fail(f"float32 loss: pallas {float(l_p32)!r} vs solve_free {float(l_s32)!r}")
    if abs(norm_p - norm_s) > 1e-2 * norm_s:
        fail(f"float32 gradient norm: pallas {norm_p!r} vs solve_free {norm_s!r}")
    print(f"training parity: float64 loss {float(l_p)!r} vs {float(l_s)!r}, 12 gradient leaves "
          f"within rtol 1e-6 (largest error / largest entry {worst:.3e}); float32 loss "
          f"{float(l_p32)!r} vs {float(l_s32)!r} (rtol 1e-3), gradient norm {norm_p!r} vs "
          f"{norm_s!r} (rtol 1e-2)", flush=True)

    # ---- step time and peak memory, float32, B = 32: the main-path
    # epoch above and one more of gp_impl='solve_free' ----
    runs = {"pallas": (trainer, times, peak, last_args)}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
        runs["solve_free"] = timed_train(CBFSSM(config("float32", "solve_free"), device=DEVICE),
                                         model_dir, ds)
    for impl, (tr, times, peak, args) in runs.items():
        step_ms = statistics.median(times[1:])
        label = f"gp_impl={impl} B={BATCH} float32"
        print(f"train step {label}: median of steps 2-{len(times)} {step_ms:.2f} ms "
              f"(step 1 {times[0]:.2f} ms), peak allocated {peak / 2**30:.3f} GiB; {card}",
              flush=True)
        if DEVICE == "cuda":
            profile_step(tr, args, label, step_ms, card)
    return launches, residual_launches


def main() -> None:
    if not (ROOT / "cbfssm_tpu_torch" / "__init__.py").is_file():
        fail("cbfssm_tpu_torch/ is not beside chip_smoke.py; run from the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_device()
    phase_build()
    max_err, times = phase_kernel()
    res_err, res_times = phase_residual_kernel()
    serve_launches = phase_serving()
    train_launches, residual_launches = phase_training(card)
    if "jax" in sys.modules:
        fail("jax was imported")
    n, m, di, d = SHAPES["recognition N=12800 M=100 DI=6 D=2"]
    n2, m2, di2, d2 = SHAPES["forward N=1600 M=100 DI=6 D=4"]
    kernels = []
    for name, line, err, t, launches, by_path, residuals in (
        ("gp_predict", 79, max_err, times, serve_launches + train_launches,
         {"serving": serve_launches, "training": train_launches}, False),
        ("gp_predict_residuals", 85, res_err, res_times, residual_launches,
         {"serving": 0, "training": residual_launches}, True),
    ):
        bound_ms, bound_by = bound(n, m, di, d, "float32", residuals)
        bound2_ms, bound2_by = bound(n2, m2, di2, d2, "float32", residuals)
        dev_ms, k_ms, p_ms = t[(torch.float32, n)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cbfssm_tpu_torch/csrc/gp_predict.cu",
            "replaces": f"cbfssm_tpu/ops/pallas/gp_predict.py:{line}",
            "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": err,
            "ms": dev_ms,
            "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "shape": f"float32 N={n} M={m} DI={di} D={d}",
            "ms_n1600": t[(torch.float32, n2)][0],
            "bound_ms_n1600": bound2_ms,
            "bound_by_n1600": bound2_by,
            "shape_n1600": f"float32 N={n2} M={m2} DI={di2} D={d2}",
            "eager_ms": k_ms,
            "device_ms_f64": {f"N={nn}": t[(torch.float64, nn)][0] for nn in TIMED_N},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
