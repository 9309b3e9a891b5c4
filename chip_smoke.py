#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``cbfssm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU, ``nvcc`` and the repository around this file; it
imports nothing of JAX. Phases, in order; any failure exits non-zero:

1. device: name and power limit (``nvidia-smi``), TF32 off;
2. build: ``nvcc`` builds ``cbfssm_tpu_torch/csrc/gp_predict.cu`` (both
   kernels, ``gp_predict`` and ``gp_predict_residuals``), and the
   library reports the largest M (inducing points) the kernels take at
   DI = 6, D = 4 and D = 2 in both dtypes, and at the (DI, D) of the
   Voliro and Sarcos GPs (12, 3), (19, 6), (21, 7), (21, 14);
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
   kernels, their summed time, the busy share and the largest kernels;
6. the other models: CBFSSMHALF and PRSSM with the GRU recognition net
   ('rnn') at the same width (var_y of length dim_y = 2), float32,
   ``gp_impl='pallas'``. Each serves as in phase 4 (every chunk
   launches ``gp_predict`` 299 times, one per forward step: these
   models have no recognition GP) and trains one epoch as in phase 5
   (16 x 299 ``gp_predict_residuals``, 3 x 299 ``gp_predict``), with the
   same parity checks of the two ``gp_impl`` paths (training from the
   trained params, predict outputs in float64 at rtol 1e-8), step time,
   peak memory, one profiled step and request latency (pallas). Last,
   the float32 GRU (the trained CBFSSMHALF leaves) and a PR-SSM conv
   net (recog_len 16) on the card against the same nets in float64 on
   the CPU: rtol 1e-5, atol 1e-6 times the largest entry, which TF32
   would miss;
7. Voliro and Sarcos, on synthetic data files written from seed 0
   (``cbfssm_tpu_torch.data.synthetic``: the flight logs, 4,000 and
   20,500 samples, and ``sarcos_inv.mat``, 66 x 674 rows of 28 columns).
   First both kernels against their plain versions at the four new
   shapes (``kernel_timing.MODEL_SHAPES``: Voliro force N 1,024 DI 12
   D 3 and recognition N 320 DI 19 D 6 at M 20; Sarcos recognition
   N 1,800 DI 21 D 7 and forward N 100 DI 21 D 14 at M 100), in both
   dtypes at phase 3's tolerances, each timed by graph replay beside its
   bound. Then ``run_voliro.main(epochs=1, config_overrides={"gp_impl":
   "pallas", "dtype": "float32"})`` at the full width of run_voliro.py
   (B 16, M 20, S 20, seq 64 / stride 50): 65 residual launches per
   Adam step, 65 value launches per test batch and 1 + T per
   ``OutputsVoliro`` predict over a log of T steps, and the arrays of
   ``voliro_forces.mat`` (finite, [T, 6], positive variances) and, where
   matplotlib is installed, ``voliro_forces.pdf`` (without it the two
   plots are skipped); and a ``Trainer`` epoch of CBFSSM at the full
   width of run_sarcos.py (dim_x 14, M 100, S 20, B 5, seq 250 / stride
   10, recog_len 16), float32, cut to 16 Adam steps: 281 launches per
   step and per test batch. For both, the two gp_impl paths on one
   batch with fixed noise (float64 loss rtol 1e-10, every gradient leaf
   rtol 1e-6, predict outputs rtol 1e-8; float32 against float64 on the
   loss terms at rtol 1e-3), the step time, peak memory and one
   profiled step;
8. lanes (multi-seed and sweep training on the lane kernels): (a) both
   lane kernels (``gp_predict_lanes``, ``gp_predict_residuals_lanes``)
   against their plain versions over the lane axis at ``LANE_SHAPES``
   (Sarcos recognition L 5 N 1,800 DI 21 D 7, Sarcos forward L 5 N 100
   D 14, RoboMove recognition L 4 N 12,800 DI 6 D 2 and forward L 4
   N 1,600 DI 6 D 4 as the sweep runs them, a ragged one) in both
   dtypes at phase 3's tolerances, one lane bitwise against the
   single-lane entry, each timed by graph replay beside L single
   launches and its bound; (b) ``vmapped_reproduction`` of the Sarcos
   CBFSSM at the full width of run_sarcos.py, 5 seeds as lanes, float32,
   'pallas', on phase 7's synthetic file with the epoch cut to 16 steps:
   each step launches ``gp_predict_residuals_lanes`` 281 times and no
   single kernel, the test loss ``gp_predict_lanes`` 281 times a batch;
   run_0..run_4 and summary.txt are written (without matplotlib the
   plots are skipped); (e) the median vmapped step against 5 x phase 7's
   single-seed step, peak memory and one profiled step; (c) in float64
   on the card, each lane's loss (rtol 1e-10) and gradients (rtol 1e-6,
   atol 1e-8 x the leaf's largest entry) against the single model on
   that lane's params, batch and noise, for the trained Sarcos lanes,
   4 lanes of the RoboMove CBFSSM ('pallas': its recognition GP at
   L 4 x 12,800 rows, the sweep's shape) and 3 lanes of the RoboMove
   CBFSSMHALF ('rnn'); (d) ``SweepTrainer`` on the RoboMove CBFSSM at
   full width over 4 values of k_factor, 4 steps: 4 x 399 residual and
   3 x 399 value lane launches, distinct lanes, unchanged hypers,
   sweep_best.json; (f) the host cost of the value path's dispatch:
   B = 1 requests of the RoboMove CBFSSM with plain calls going straight
   to the kernel wrapper (as they do) against every call forced through
   ``FusedPredictValue``, alternated, and 2,000 bare calls each way;
9. the CLI and the HTTP server, at the RoboMove phase-0 width, float32:
   (a) ``cbfssm_tpu_torch.__main__.main(["reproduce", "robomove",
   "--epochs", "1", "--root", DIR])`` in this process: both curriculum
   phases, one full epoch each (16 x 399 ``gp_predict_residuals``,
   3 x 399 ``gp_predict``), and each phase's OutputsRoboMove (4 x 399 +
   100 + T - 1 ``gp_predict`` over the T-step test experiment; without
   matplotlib the PDFs are skipped and every prediction still runs);
   (b) ``info DIR``; (c) ``eval DIR --out DIR2``: the same Outputs from
   model_meta.json and best.ckpt alone, its mse.txt equal to (a)'s;
   (d) a ``PredictionServer`` in this process over
   ``load_trained_model(DIR)``: 3 single requests and then 32
   concurrent single-window requests, in JSON and in ``.npz``, then
   ``/v1/params`` with model.ckpt and two more requests; every reply
   equal to the direct ``BucketedPredictor`` call of its dispatch
   (generator seed ``fold_seed(0, k)``), 399 launches a dispatch;
   request latencies and the hot-swap time; (e) ``serve DIR --port 0``
   in a subprocess: one request, then SIGTERM must end it with exit 0.

Each phase prints its seconds. The main paths are phases 4, 5 and 6's
four, phase 7's two (``voliro``: training, test loss and outputs;
``training_sarcos``), phase 8's two (``lanes``: the Sarcos seeds'
training, test loss and outputs; ``sweep``) and phase 9's four
(``cli_reproduce``, ``cli_eval``, ``http_serve``, and ``cli_serve``,
counted by the subprocess itself): each sets the launch counts (the
lane kernels' included) to 0 just before it and reads them just after,
and the kernels line lists them by path (``launches_by_path``;
``launches`` is their sum).

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the card, and the line before that lists the kernels with their
checks and times: ``ms`` is the graph-replayed device time at the
recognition shape (float32, N = 12,800), ``ms_n1600`` the same at the
forward shape (N = 1,600), each beside its bound (``bound_ms``,
``bound_ms_n1600``); ``eager_ms`` is the back-to-back figure,
``device_ms_f64`` has the same device times in float64, and
``model_shapes`` the figures of phase 7's four shapes. The two lane
kernels follow, with their figures at the Sarcos recognition shape of
phase 8 (``ms_singles``: the same work as L single launches) and
``lane_shapes`` for all five.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEQ_LEN, SEQ_STRIDE = 300, 50
BUCKETS = (1, 8, 32)
STEPS_PER_CHUNK = 2 * 50 + (SEQ_LEN - 1)  # CBFSSM: blocked recognition + forward
FORWARD_STEPS = SEQ_LEN - 1  # CBFSSMHALF and PRSSM: the forward rollout only
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
# (DI, D) of the Voliro force and recognition GPs and the Sarcos
# recognition and forward GPs
MODEL_WIDTHS = ((12, 3), (19, 6), (21, 7), (21, 14))
SARCOS_STEPS = 16  # Adam steps of phase 7's Sarcos epoch (a full one is 120)
SARCOS_SEEDS = 5  # run_sarcos.iterations: phase 8's lanes
# phase 8's lane-kernel shapes (L, N, M, DI, D): Sarcos recognition and
# forward at 5 lanes, RoboMove recognition and forward at 4 (the sweep),
# a ragged one
LANE_SHAPES = {
    "sarcos recognition": (5, 1800, 100, 21, 7),
    "sarcos forward": (5, 100, 100, 21, 14),
    "robomove recognition": (4, 12800, 100, 6, 2),
    "robomove forward": (4, 1600, 100, 6, 4),
    "ragged": (3, 37, 11, 5, 3),
}
SWEEP_K_FACTOR = (1.0, 10.0, 50.0, 200.0)  # phase 8's RoboMove sweep
SWEEP_STEPS = 4
STEP_MS = {}  # median train steps, by path, for phase 8's comparison


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def config(dtype: str, gp_impl: str, **overrides) -> dict:
    """The phase-0 RoboMove config of the port's run script."""
    from cbfssm_tpu_torch import run_robomove

    return run_robomove.model_config(0, {"dtype": dtype, "gp_impl": gp_impl, **overrides})


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
    import torch

    from cbfssm_tpu_torch.ops import fused_predict as fp

    t0 = time.perf_counter()
    fp._library()
    print(f"build: gp_predict.cu built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    caps = {f"{dt} D={d}": fp.max_inducing_points(getattr(torch, dt), 6, d)
            for dt in ("float32", "float64") for d in (4, 2)}
    print(f"inducing-point cap at DI=6 (largest M the kernels take): {caps}", flush=True)
    caps = {f"{dt} DI={di} D={d}": fp.max_inducing_points(getattr(torch, dt), di, d)
            for dt in ("float32", "float64") for di, d in MODEL_WIDTHS}
    print(f"inducing-point cap at the Voliro and Sarcos widths: {caps}", flush=True)


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


def check_output(out, n, where):
    """Shapes (dim_y 2, dim_x 4), finiteness and positive variances of a
    served PredictOutput of n rows."""
    import numpy as np

    for name, dim in (("pred_mean", 2), ("pred_var", 2), ("internal_mean", 4),
                      ("internal_var", 4), ("sde", 2)):
        a = getattr(out, name)
        if a.shape != (n, SEQ_LEN, dim):
            fail(f"{where}: {name} has shape {a.shape}, want {(n, SEQ_LEN, dim)}")
        if not np.isfinite(a).all():
            fail(f"{where}: {name} is not finite")
    if not (out.pred_var > 0).all() or not np.isfinite(out.mse):
        fail(f"{where}: non-positive pred_var or non-finite mse")


def serve_main_path(model, params, u_all, y_all, steps_per_chunk: int, where: str) -> int:
    """A serving main path: 40 requests through ``BucketedPredictor`` +
    ``MicroBatcher`` from 4 threads, then one 40-row request (chunks of
    32 and 8). The launch counts go to 0 just before and are read just
    after: every dispatched chunk must launch ``gp_predict``
    ``steps_per_chunk`` times, and ``gp_predict_residuals`` never runs.
    Returns the ``gp_predict`` launches."""
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.serving import BucketedPredictor, MicroBatcher

    bp = BucketedPredictor(model, params, SEQ_LEN, buckets=BUCKETS)
    bp(u_all[:1], y_all[:1])  # first request: cuBLAS / allocator set-up
    sync()
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
            fail(f"{where}: MicroBatcher clients did not finish")
        stats = mb.stats()
    chunked = bp(u_all[:40], y_all[:40])  # 40 rows: chunks of 32 and 8
    launches = fp.fused_predict.launches
    residual_launches = fp.fused_predict_residuals.launches
    if residual_launches != 0:
        fail(f"{where}: serving launched gp_predict_residuals {residual_launches} times, want 0")
    for i, out in enumerate(results):
        if out is None:
            fail(f"{where}: request {i} got no result")
        check_output(out, 1, f"{where} MicroBatcher request {i}")
    check_output(chunked, 40, f"{where} chunked request")
    dispatches = stats["batches"] + 2
    if launches != steps_per_chunk * dispatches:
        fail(f"{where}: kernel launches {launches} != {steps_per_chunk} x {dispatches} "
             "dispatches")
    print(f"serving {where}: {n_req} MicroBatcher requests from {n_threads} threads in "
          f"{stats['batches']} batches (max {stats['max_batch_seen']}), one 40-row "
          f"request in 2 chunks; {launches} kernel launches = {steps_per_chunk} x "
          f"{dispatches} dispatches; outputs finite", flush=True)
    return launches


def predict_parity(make_model, params, u8, y8, where: str, seq_len: int = SEQ_LEN):
    """The kernel path against ``gp_impl='solve_free'`` on one batch of 8
    and one seed: float64 outputs elementwise (rtol 1e-8, atol 1e-10);
    float32 mse and mean pred_var (rtol 1e-3), since hundreds of chained
    steps amplify float32 rounding."""
    import numpy as np

    from cbfssm_tpu_torch.serving import CompiledPredictor

    outs = {}
    for dtype in ("float64", "float32"):
        for impl in ("pallas", "solve_free"):
            m = make_model(dtype, impl)
            out = CompiledPredictor(m, params.to(m.dtype), 8, seq_len, seed=123)(u8, y8)
            outs[(dtype, impl)] = out.map(lambda a: a.double().cpu().numpy())
    k64, p64 = outs[("float64", "pallas")], outs[("float64", "solve_free")]
    for name in ("pred_mean", "pred_var", "internal_mean", "internal_var"):
        a, b = getattr(k64, name), getattr(p64, name)
        if not np.allclose(a, b, rtol=1e-8, atol=1e-10):
            fail(f"{where}: float64 {name}: kernel path vs solve_free differ by "
                 f"{np.abs(a - b).max():.3e}")
    f64_err = max(float(np.abs(getattr(k64, n) - getattr(p64, n)).max())
                  for n in ("pred_mean", "pred_var"))
    stats32 = {impl: (float(outs[("float32", impl)].mse),
                      float(outs[("float32", impl)].pred_var.mean()))
               for impl in ("pallas", "solve_free")}
    for i, name in enumerate(("mse", "mean pred_var")):
        a, b = stats32["pallas"][i], stats32["solve_free"][i]
        if abs(a - b) > 1e-3 * abs(b):
            fail(f"{where}: float32 {name}: kernel path {a!r} vs solve_free {b!r}")
    print(f"parity {where}: float64 outputs max abs diff {f64_err:.3e} (rtol 1e-8); float32 "
          f"kernel (mse, mean pred_var) {stats32['pallas']} vs solve_free "
          f"{stats32['solve_free']} (rtol 1e-3)", flush=True)


def request_latency(make_model, params, u_all, y_all, impls, card: str, where: str):
    """Median host time of 5 ``BucketedPredictor`` requests at B = 1 and
    B = 32, float32, after one warm-up request each."""
    from cbfssm_tpu_torch.serving import BucketedPredictor

    for impl in impls:
        pred = BucketedPredictor(make_model("float32", impl), params, SEQ_LEN, buckets=BUCKETS)
        for b in (1, 32):
            pred(u_all[:b], y_all[:b])
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                pred(u_all[:b], y_all[:b])
                times.append(1e3 * (time.perf_counter() - t0))
            med = sorted(times)[len(times) // 2]
            print(f"latency {where} gp_impl={impl} B={b}: median {med:.2f} ms over 5 requests "
                  f"({', '.join(f'{t:.2f}' for t in times)}); {card}", flush=True)


def served_windows():
    from cbfssm_tpu_torch.data import RoboMove

    ds = RoboMove(SEQ_LEN, SEQ_STRIDE)
    if ds.test_in_batch.shape[0] < 40:
        fail(f"RoboMove gives {ds.test_in_batch.shape[0]} test windows, need 40")
    return ds.test_in_batch, ds.test_out_batch


def phase_serving(card: str):
    import torch

    from cbfssm_tpu_torch.models import CBFSSM

    u_all, y_all = served_windows()

    def make_model(dtype, impl):
        return CBFSSM(config(dtype, impl), device=DEVICE)

    model = make_model("float32", "pallas")
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    launches = serve_main_path(model, params, u_all, y_all, STEPS_PER_CHUNK, "CBFSSM")
    predict_parity(make_model, params, u_all[:8], y_all[:8], "CBFSSM")
    request_latency(make_model, params, u_all, y_all, ("pallas", "solve_free"), card, "CBFSSM")
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


def report_steps(label: str, run, card: str):
    """The median step time (steps 2-16) and peak memory of a
    ``timed_train`` run, then one profiled step."""
    import statistics

    tr, times, peak, args = run
    step_ms = statistics.median(times[1:])
    print(f"train step {label}: median of steps 2-{len(times)} {step_ms:.2f} ms "
          f"(step 1 {times[0]:.2f} ms), peak allocated {peak / 2**30:.3f} GiB; {card}",
          flush=True)
    if DEVICE == "cuda":
        profile_step(tr, args, label, step_ms, card)
    return step_ms


def loss_and_grads(model, params, u, y, noise):
    """(loss, [grad of each leaf], aux) of one batch."""
    import torch

    leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
    loss, aux = model.loss(params.with_tensors(leaves), u, y, condition=True, noise=noise)
    return (loss.detach(), list(torch.autograd.grad(loss, leaves)),
            {k: float(v.detach()) for k, v in aux.items()})


def robomove():
    from cbfssm_tpu_torch.data import RoboMove

    ds = RoboMove(SEQ_LEN, SEQ_STRIDE)
    n_train, n_test = ds.train_in_batch.shape[0], ds.test_in_batch.shape[0]
    if (n_train, n_test) != (TRAIN_WINDOWS, TEST_WINDOWS):
        fail(f"RoboMove gives {n_train}/{n_test} windows, want {TRAIN_WINDOWS}/{TEST_WINDOWS}")
    return ds


def train_main_path(model, ds, steps_per_batch: int, where: str):
    """A training main path: one ``Trainer.train`` epoch (RoboMove: 16
    Adam steps, 3 test batches). The launch counts go to 0 just before and are read
    just after: each step must launch ``gp_predict_residuals``
    ``steps_per_batch`` times and each test batch ``gp_predict`` as
    often. Losses must be finite, and both checkpoints must restore.
    Returns the ``timed_train`` run and the two counts."""
    import tempfile

    import numpy as np
    import torch

    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.training import Trainer, checkpoint

    batch = int(model.config.batch_size)
    steps = -(-ds.train_in_batch.shape[0] // batch)
    test_batches = -(-ds.test_in_batch.shape[0] // batch)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
        fp.fused_predict.launches = 0
        fp.fused_predict_residuals.launches = 0
        t0 = time.perf_counter()
        run = timed_train(model, model_dir, ds)
        epoch_s = time.perf_counter() - t0
        residual_launches = fp.fused_predict_residuals.launches
        launches = fp.fused_predict.launches
        trainer = run[0]
        if not (np.isfinite(trainer.train_all).all() and np.isfinite(trainer.test_all).all()):
            fail(f"{where}: non-finite losses: train {trainer.train_all}, "
                 f"test {trainer.test_all}")
        if residual_launches != steps * steps_per_batch:
            fail(f"{where}: gp_predict_residuals launches {residual_launches} != {steps} steps "
                 f"x {steps_per_batch}")
        if launches != test_batches * steps_per_batch:
            fail(f"{where}: gp_predict launches {launches} != {test_batches} test batches x "
                 f"{steps_per_batch}")
        for name in (checkpoint.BEST, checkpoint.LAST):
            if not checkpoint.exists(f"{model_dir}/{name}"):
                fail(f"{where}: {name} was not written")
        restored = Trainer(model, model_dir, seed=0).restore(checkpoint.LAST)
        for a, b in zip(restored.tensors(), trainer.params.tensors(), strict=True):
            if not torch.equal(a.detach(), b.detach()):
                fail(f"{where}: model.ckpt does not restore the trained params")
        Trainer(model, model_dir, seed=0).restore(checkpoint.BEST)
    print(f"training {where}: 1 epoch of {steps} Adam steps + {test_batches} test batches in "
          f"{epoch_s:.2f} s; train loss {trainer.train_all[0]!r}, test loss "
          f"{trainer.test_all[0]!r}; gp_predict_residuals launches {residual_launches} = "
          f"{steps} x {steps_per_batch}, gp_predict launches {launches} = {test_batches} x "
          f"{steps_per_batch}; best.ckpt and model.ckpt restore", flush=True)
    return run, launches, residual_launches


def gradient_parity(make_model, params0, ds, where: str, batch: int = BATCH,
                    seq_len: int = SEQ_LEN, f32_vs_f64: bool = False):
    """The loss and every gradient leaf of one fixed batch (of 32 by
    default) and one draw of noise under 'pallas' and 'solve_free':
    float64 loss at rtol 1e-10, each leaf at rtol 1e-6 with atol 1e-8
    times its largest entry; float32 loss at rtol 1e-3 and global
    gradient norm at rtol 1e-2 (hundreds of chained steps amplify
    float32 rounding). With ``f32_vs_f64`` all four runs share one
    float64 draw, and the float32 kernel path is also held against
    float64: loglik, kl_x and the global term at rtol 1e-3, the loss at
    1e-3 of the scale of its terms."""
    import torch

    u = torch.as_tensor(ds.train_in_batch[:batch], device=DEVICE)
    y = torch.as_tensor(ds.train_out_batch[:batch], device=DEVICE)
    res = {}
    # float32 against float64 needs the same draws in both dtypes
    shared = (make_model("float64", "pallas").draw_noise(
        torch.Generator(DEVICE).manual_seed(7), seq_len, batch) if f32_vs_f64 else None)
    for dtype in ("float64", "float32"):
        for impl in ("pallas", "solve_free"):
            m = make_model(dtype, impl)
            if shared is None:
                noise = m.draw_noise(torch.Generator(DEVICE).manual_seed(7), seq_len, batch)
            else:
                noise = dataclasses.replace(shared, **{
                    f.name: getattr(shared, f.name).to(m.dtype)
                    for f in dataclasses.fields(shared)})
            res[(dtype, impl)] = loss_and_grads(m, params0.to(m.dtype), u, y, noise)
    (l_p, g_p, aux64), (l_s, g_s, _) = res[("float64", "pallas")], res[("float64", "solve_free")]
    if abs(float(l_p) - float(l_s)) > 1e-10 * abs(float(l_s)):
        fail(f"{where}: float64 loss: pallas {float(l_p)!r} vs solve_free {float(l_s)!r}")
    worst = 0.0
    for k, (a, b) in enumerate(zip(g_p, g_s)):
        scale = float(b.abs().max())
        err = (a - b).abs()
        if bool((err > 1e-6 * b.abs() + 1e-8 * scale).any()):
            fail(f"{where}: float64 gradient of leaf {k}: max abs err {float(err.max()):.3e}, "
                 f"largest entry {scale:.3e} (rtol 1e-6, atol 1e-8 x largest)")
        worst = max(worst, float(err.max()) / max(scale, 1e-300))
    (l_p32, g_p32, aux32), (l_s32, g_s32, _) = (res[("float32", "pallas")],
                                                 res[("float32", "solve_free")])
    norm_p = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in g_p32)))
    norm_s = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in g_s32)))
    if abs(float(l_p32) - float(l_s32)) > 1e-3 * abs(float(l_s32)):
        fail(f"{where}: float32 loss: pallas {float(l_p32)!r} vs solve_free {float(l_s32)!r}")
    if abs(norm_p - norm_s) > 1e-2 * norm_s:
        fail(f"{where}: float32 gradient norm: pallas {norm_p!r} vs solve_free {norm_s!r}")
    if f32_vs_f64:
        # the loss is a difference of large terms (loglik - kl_x, then the
        # global term): hold each term at rtol 1e-3, and the loss at 1e-3
        # of the terms' scale
        for k in ("loglik", "kl_x", "global_term"):
            if abs(aux32[k] - aux64[k]) > 1e-3 * abs(aux64[k]):
                fail(f"{where}: float32 {k} {aux32[k]!r} vs float64 {aux64[k]!r} (rtol 1e-3)")
        scale = abs(aux64["particle_sum"]) / aux64["particle_divisor"] + abs(aux64["global_term"])
        if abs(float(l_p32) - float(l_p)) > 1e-3 * scale:
            fail(f"{where}: float32 loss {float(l_p32)!r} vs float64 {float(l_p)!r} (atol 1e-3 "
                 f"x {scale:.6g}, the scale of its terms)")
    print(f"training parity {where}: float64 loss {float(l_p)!r} vs {float(l_s)!r}, "
          f"{len(g_p)} gradient leaves within rtol 1e-6 (largest error / largest entry "
          f"{worst:.3e}); float32 loss {float(l_p32)!r} vs {float(l_s32)!r} (rtol 1e-3), "
          f"gradient norm {norm_p!r} vs {norm_s!r} (rtol 1e-2)"
          + (f"; float32 vs float64 loglik {aux32['loglik']!r} vs {aux64['loglik']!r}, kl_x "
             f"{aux32['kl_x']!r} vs {aux64['kl_x']!r}" if f32_vs_f64 else ""), flush=True)


def phase_training(card: str):
    """One full-width RoboMove epoch of CBFSSM through Trainer (the main
    path), then gradient parity and step times of both gp_impl values."""
    import tempfile

    from cbfssm_tpu_torch.models import CBFSSM

    def make_model(dtype, impl):
        return CBFSSM(config(dtype, impl), device=DEVICE)

    ds = robomove()
    run, launches, residual_launches = train_main_path(
        make_model("float32", "pallas"), ds, STEPS_PER_CHUNK, "CBFSSM")
    gradient_parity(make_model, run[0].params.detach(), ds, "CBFSSM")
    # step time and peak memory, float32, B = 32: the main-path epoch
    # above and one more of gp_impl='solve_free'
    report_steps(f"CBFSSM gp_impl=pallas B={BATCH} float32", run, card)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
        plain = timed_train(make_model("float32", "solve_free"), model_dir, ds)
    report_steps(f"CBFSSM gp_impl=solve_free B={BATCH} float32", plain, card)
    return launches, residual_launches


def recognition_parity(params):
    """The float32 recognition nets on the card against the same nets in
    float64 on the CPU (rtol 1e-5, atol 1e-6 times the largest entry;
    TF32 would miss it): the GRU with the trained CBFSSMHALF leaves over
    the first recog_len = 50 steps of 32 RoboMove windows, and a PR-SSM
    conv net (recog_len 16) with leaves drawn from a seed."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.models import recognition

    u_all, y_all = served_windows()
    uy = np.concatenate((u_all[:BATCH], y_all[:BATCH]), axis=-1)
    d_in, dim_x = uy.shape[-1], 4
    conv = recognition.make_recognition("conv", d_in, dim_x, 16, torch.float64)
    conv_leaves = recognition.init_leaves(conv, torch.Generator().manual_seed(0),
                                          torch.float64, "cpu")
    gru_leaves = {k: v.detach().double().cpu() for k, v in params.recog.items()}
    for kind, leaves, steps in (("rnn", gru_leaves, 50), ("conv", conv_leaves, 16)):
        x64 = torch.as_tensor(uy[:, :steps], dtype=torch.float64)
        want = recognition.apply(recognition.make_recognition(kind, d_in, dim_x, steps,
                                                              torch.float64), leaves, x64)
        net32 = recognition.make_recognition(kind, d_in, dim_x, steps, torch.float32)
        got = recognition.apply(net32, {k: v.float().to(DEVICE) for k, v in leaves.items()},
                                x64.float().to(DEVICE)).double().cpu()
        scale = float(want.abs().max())
        err = (got - want).abs()
        if bool((err > 1e-5 * want.abs() + 1e-6 * scale).any()):
            fail(f"recognition {kind}: float32 on {DEVICE} vs float64 on the CPU: max abs err "
                 f"{float(err.max()):.3e}, largest entry {scale:.3e} (rtol 1e-5)")
        print(f"recognition {kind}: float32 on {DEVICE} vs float64 on the CPU, max abs err "
              f"{float(err.max()):.3e} of largest entry {scale:.3e} (rtol 1e-5)", flush=True)


def phase_other_models(card: str):
    """CBFSSMHALF and PRSSM ('rnn') at the phase-0 RoboMove width (dim_y
    2, so var_y of length 2): serving, one training epoch, parity of the
    two gp_impl paths, step time, latency; then the recognition nets in
    float32 on the card against float64 on the CPU. Returns the launch
    counts by path."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.models import CBFSSMHALF, PRSSM

    ds = robomove()
    u_all, y_all = served_windows()
    by_path, half_params = {}, None
    for name, cls in (("cbfssmhalf", CBFSSMHALF), ("prssm", PRSSM)):
        def make_model(dtype, impl, cls=cls):
            return cls(config(dtype, impl, var_y=np.asarray([1.0**2] * 2), recog_model="rnn"),
                       device=DEVICE)

        where = cls.__name__
        model = make_model("float32", "pallas")
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
        serve = serve_main_path(model, params, u_all, y_all, FORWARD_STEPS, where)
        run, launches, residual_launches = train_main_path(model, ds, FORWARD_STEPS, where)
        trained = run[0].params.detach()
        gradient_parity(make_model, trained, ds, where)
        predict_parity(make_model, trained, u_all[:8], y_all[:8], where)
        report_steps(f"{where} gp_impl=pallas B={BATCH} float32", run, card)
        request_latency(make_model, trained, u_all, y_all, ("pallas",), card, where)
        by_path[f"serving_{name}"] = (serve, 0)
        by_path[f"training_{name}"] = (launches, residual_launches)
        if cls is CBFSSMHALF:
            half_params = trained
    recognition_parity(half_params)
    return by_path


def phase_model_kernels():
    """Both kernels against their plain versions at the Voliro and
    Sarcos shapes (``kernel_timing.MODEL_SHAPES``), in float32 (rtol
    2e-5, atol 1e-5) and float64 (rtol 1e-10, atol 1e-12), each timed by
    graph replay beside its bound and 50 eager calls of its plain
    version. Returns {kernel: {path: figures}}."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.utils.kernel_timing import MODEL_SHAPES, graph_replay_ms, kernel_inputs

    def residuals_plain(*args):
        mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
        return mean, var, kmn, w

    tol = {torch.float32: (2e-5, 1e-5), torch.float64: (1e-10, 1e-12)}
    kernels = {"gp_predict": (fp._fused_predict_value, fp.fused_predict_plain, False),
               "gp_predict_residuals": (fp.fused_predict_residuals, residuals_plain, True)}
    out = {name: {} for name in kernels}
    rng = np.random.default_rng(2)
    for path, (n, m, di, d) in MODEL_SHAPES.items():
        for dtype, (rtol, atol) in tol.items():
            args = kernel_inputs(rng, n, m, di, d, dtype, DEVICE)
            for name, (kernel, plain, residuals) in kernels.items():
                got = kernel(*args)
                sync()
                want = plain(*args)
                err = 0.0
                for g, w in zip(got, want):
                    e = (g - w).abs()
                    if bool((e > atol + rtol * w.abs()).any()):
                        fail(f"{name} {path} {dtype}: max abs err {float(e.max()):.3e} outside "
                             f"rtol {rtol} atol {atol}")
                    err = max(err, float(e.max()))
                dev_ms = graph_replay_ms(lambda: kernel(*args))
                plain_ms = cuda_ms(lambda: plain(*args), 50)
                dt = str(dtype)[6:]
                bound_ms, bound_by = bound(n, m, di, d, dt, residuals)
                fig = out[name].setdefault(path, {"shape": f"N={n} M={m} DI={di} D={d}"})
                if dtype == torch.float32:
                    fig.update(ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, max_abs_err=err)
                else:
                    fig.update(ms_f64=dev_ms, plain_ms_f64=plain_ms, bound_ms_f64=bound_ms)
                print(f"{name} {dt} {path} N={n} M={m} DI={di} D={d}: ok (max abs err "
                      f"{err:.3e}); device {dev_ms:.5f} ms (graph replay), bound "
                      f"{bound_ms:.5f} ms ({bound_by}), plain {plain_ms:.4f} ms", flush=True)
    return out


def timed_steps(trainer, args, n: int):
    """``n + 1`` ``train_step`` calls on one batch, each timed on the
    host clock up to a device sync; the peak allocated device memory
    over them. The ``timed_train`` tuple, for ``report_steps``."""
    import torch

    times = []
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for _ in range(n + 1):
        t0 = time.perf_counter()
        trainer.train_step(*args)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    return trainer, times, peak, args


def voliro_predict_parity(make_model, params, u, y):
    """Voliro's predict dict under 'pallas' against 'solve_free' in
    float64 on one batch and seed: every output at rtol 1e-8, atol
    1e-10 (the batch predictors do not take a dict-predict model)."""
    import numpy as np
    import torch

    outs = {}
    for impl in ("pallas", "solve_free"):
        m = make_model("float64", impl)
        with torch.inference_mode():
            gen = torch.Generator(device=DEVICE).manual_seed(123)
            out = m.predict(params.to(m.dtype), u, y, gen)
        outs[impl] = {k: v.cpu().numpy() for k, v in out.items()}
    worst = 0.0
    for k, a in outs["pallas"].items():
        b = outs["solve_free"][k]
        if not (np.isfinite(a).all() and np.allclose(a, b, rtol=1e-8, atol=1e-10)):
            fail(f"Voliro: float64 predict {k}: kernel path vs solve_free differ by "
                 f"{np.abs(a - b).max():.3e}")
        worst = max(worst, float(np.abs(a - b).max()))
    print(f"parity Voliro: float64 predict ({', '.join(outs['pallas'])}) max abs diff "
          f"{worst:.3e} (rtol 1e-8)", flush=True)


def phase_voliro(card: str, data_dir: str):
    """The Voliro main path: ``run_voliro.main`` at the full width of
    run_voliro.py (B 16, M 20, S 20, seq 64 / stride 50), float32,
    'pallas', one epoch, on synthetic flight logs. Each Adam step
    launches ``gp_predict_residuals`` 1 + T times (the batched force GP,
    then one recognition step per time step; the forward pass is pure
    physics), each test batch and each ``OutputsVoliro`` predict over a
    log of T steps ``gp_predict`` 1 + T times. Then the parity of the two
    gp_impl paths, step time and peak memory (10 steps on one batch), and
    one profiled step. Returns the launches (value, residual)."""
    import importlib.util
    import os
    import tempfile

    import numpy as np
    import scipy.io
    import torch

    from cbfssm_tpu_torch import run_voliro
    from cbfssm_tpu_torch.models import Voliro
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.outputs import Outputs, OutputsVoliro

    def make_model(dtype, impl):
        return Voliro(dict(run_voliro.model_config, dtype=dtype, gp_impl=impl), device=DEVICE)

    seq_len, batch = run_voliro.seq_len, run_voliro.model_config["batch_size"]
    # without matplotlib (the card's machine may lack it) the two plots
    # are skipped here, and only here; voliro_forces.mat is checked
    plots = importlib.util.find_spec("matplotlib") is not None
    saved = Outputs.training_stats, OutputsVoliro._plot_forces
    if not plots:
        Outputs.training_stats = OutputsVoliro._plot_forces = lambda self, *a: None
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
            fp.fused_predict.launches = 0
            fp.fused_predict_residuals.launches = 0
            t0 = time.perf_counter()
            outputs = run_voliro.main(
                root=root, epochs=1, data_dir=data_dir,
                config_overrides={"gp_impl": "pallas", "dtype": "float32"}, device=DEVICE)
            sync()
            run_s = time.perf_counter() - t0
            launches = fp.fused_predict.launches
            residual_launches = fp.fused_predict_residuals.launches
            if plots and os.path.getsize(os.path.join(root, "voliro_forces.pdf")) == 0:
                fail("Voliro: voliro_forces.pdf is empty")
            forces = scipy.io.loadmat(os.path.join(root, "voliro_forces.mat"))
    finally:
        Outputs.training_stats, OutputsVoliro._plot_forces = saved
    trainer, ds = outputs.trainer, outputs.ds
    if not (np.isfinite(trainer.train_all).all() and np.isfinite(trainer.test_all).all()):
        fail(f"Voliro: non-finite losses: train {trainer.train_all}, test {trainer.test_all}")
    steps = -(-ds.train_in_batch.shape[0] // batch)
    test_batches = -(-ds.test_in_batch.shape[0] // batch)
    logs = (ds.train_in.shape[1] + ds.test_in.shape[1], ds.test_in2.shape[1])
    want_value = test_batches * (1 + seq_len) + sum(1 + t for t in logs)
    if residual_launches != steps * (1 + seq_len):
        fail(f"Voliro: gp_predict_residuals launches {residual_launches} != {steps} steps x "
             f"{1 + seq_len}")
    if launches != want_value:
        fail(f"Voliro: gp_predict launches {launches} != {test_batches} test batches x "
             f"{1 + seq_len} + OutputsVoliro predicts over logs of {logs} steps (1 + T each)")
    for tag, t_len in zip(("train", "transfer"), logs):
        for k in ("force_torque", "ft_mean", "ft_var"):
            a = forces[f"{k}_{tag}"]
            if a.shape != (t_len, 6) or not np.isfinite(a).all():
                fail(f"Voliro: voliro_forces.mat {k}_{tag} has shape {a.shape} (want "
                     f"{(t_len, 6)}) or is not finite")
        if not (forces[f"ft_var_{tag}"] > 0).all():
            fail(f"Voliro: voliro_forces.mat ft_var_{tag} is not positive")
    print(f"Voliro: run_voliro.main, 1 epoch ({steps} Adam steps, {test_batches} test batches) "
          f"and OutputsVoliro in {run_s:.2f} s; train loss {trainer.train_all[0]!r}, test loss "
          f"{trainer.test_all[0]!r}; gp_predict_residuals launches {residual_launches} = "
          f"{steps} x {1 + seq_len}, gp_predict launches {launches} = {test_batches} x "
          f"{1 + seq_len} + {' + '.join(f'(1 + {t})' for t in logs)}; voliro_forces.mat "
          "finite, "
          + ("voliro_forces.pdf written" if plots else
             "plots skipped: matplotlib is not installed here"), flush=True)

    params = trainer.params.detach()
    gradient_parity(make_model, params, ds, "Voliro", batch=batch, seq_len=seq_len,
                    f32_vs_f64=True)
    voliro_predict_parity(make_model, params, ds.train_in_batch[:batch],
                          ds.train_out_batch[:batch])
    kw = dict(dtype=torch.float32, device=DEVICE)
    args = (torch.as_tensor(ds.train_in_batch[:batch], **kw),
            torch.as_tensor(ds.train_out_batch[:batch], **kw), torch.ones(batch, **kw),
            torch.Generator(device=DEVICE).manual_seed(5))
    report_steps(f"Voliro gp_impl=pallas B={batch} float32 (10 steps on one batch)",
                 timed_steps(trainer, args, 10), card)
    return launches, residual_launches


def phase_sarcos(card: str, data_dir: str):
    """The Sarcos training path: CBFSSM at the full width of
    run_sarcos.py (dim_x 14, M 100, S 20, B 5, seq 250 / stride 10,
    recog_len 16), float32, 'pallas', through ``Trainer`` for one epoch
    cut to 16 Adam steps (the first 80 of the 600 training windows of a
    synthetic sarcos_inv.mat; all 60 test windows). Each step launches
    ``gp_predict_residuals`` 281 times (2 x 16 blocked recognition steps
    + 249 forward steps), each test batch ``gp_predict`` as often. Then
    the parity of the two gp_impl paths, step time, peak memory and one
    profiled step. Returns the launches (value, residual)."""
    from cbfssm_tpu_torch import run_sarcos
    from cbfssm_tpu_torch.data import Sarcos
    from cbfssm_tpu_torch.models import CBFSSM

    def make_model(dtype, impl):
        return CBFSSM(dict(run_sarcos.model_config, dtype=dtype, gp_impl=impl), device=DEVICE)

    seq_len, batch = run_sarcos.seq_len, run_sarcos.model_config["batch_size"]
    recog_len = run_sarcos.model_config["recog_len"]
    ds = Sarcos(seq_len, run_sarcos.seq_stride, data_dir=data_dir)
    if ds.train_in_batch.shape[0] < SARCOS_STEPS * batch:
        fail(f"Sarcos gives {ds.train_in_batch.shape[0]} training windows")
    ds.train_in_batch = ds.train_in_batch[:SARCOS_STEPS * batch]
    ds.train_out_batch = ds.train_out_batch[:SARCOS_STEPS * batch]
    per_batch = 2 * recog_len + seq_len - 1
    run, launches, residual_launches = train_main_path(make_model("float32", "pallas"), ds,
                                                       per_batch, "Sarcos")
    params = run[0].params.detach()
    gradient_parity(make_model, params, ds, "Sarcos", batch=batch, seq_len=seq_len,
                    f32_vs_f64=True)
    predict_parity(make_model, params, ds.test_in_batch[:8], ds.test_out_batch[:8], "Sarcos",
                   seq_len=seq_len)
    STEP_MS["sarcos"] = report_steps(f"Sarcos gp_impl=pallas B={batch} float32", run, card)
    return launches, residual_launches


def phase_voliro_sarcos(card: str):
    """Phase 7: the kernels at the new shapes, then Voliro and Sarcos on
    synthetic data files written from seed 0."""
    import tempfile

    from cbfssm_tpu_torch.data import synthetic

    model_kernels = phase_model_kernels()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as data_dir:
        synthetic.stage_all(data_dir, seed=0)
        paths = {"voliro": phase_voliro(card, data_dir),
                 "training_sarcos": phase_sarcos(card, data_dir)}
    return model_kernels, paths


def phase_lane_kernels():
    """(a) Both lane kernels against their plain versions over the lane
    axis at ``LANE_SHAPES``, in float32 (rtol 2e-5, atol 1e-5) and
    float64 (rtol 1e-10, atol 1e-12); one lane against the single-lane
    entry point (bitwise: the same launch); each timed by graph replay
    beside L single launches of the same work, its bound (L times one
    lane's) and 20 eager calls of its plain version. Returns {kernel:
    {shape: figures}}."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.utils.kernel_timing import graph_replay_ms, kernel_inputs

    def residuals_plain(*args):
        mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
        return mean, var, kmn, w

    tol = {torch.float32: (2e-5, 1e-5), torch.float64: (1e-10, 1e-12)}
    kernels = {
        "gp_predict_lanes": (fp.fused_predict_lanes, fp.fused_predict_plain,
                             fp._fused_predict_value, False),
        "gp_predict_residuals_lanes": (fp.fused_predict_residuals_lanes, residuals_plain,
                                       fp.fused_predict_residuals, True),
    }
    out = {name: {} for name in kernels}
    rng = np.random.default_rng(3)
    for path, (lanes, n, m, di, d) in LANE_SHAPES.items():
        for dtype, (rtol, atol) in tol.items():
            per_lane = [kernel_inputs(rng, n, m, di, d, dtype, DEVICE) for _ in range(lanes)]
            args = [torch.stack(ts) for ts in zip(*per_lane)]
            dt = str(dtype)[6:]
            for name, (kernel, plain, single, residuals) in kernels.items():
                got = kernel(*args)
                sync()
                want = plain(*args)
                err = 0.0
                for g, w in zip(got, want):
                    e = (g - w).abs()
                    if bool((e > atol + rtol * w.abs()).any()):
                        fail(f"{name} {path} {dt}: max abs err {float(e.max()):.3e} outside "
                             f"rtol {rtol} atol {atol}")
                    err = max(err, float(e.max()))
                one = kernel(*(a[:1] for a in args))
                ref = single(*per_lane[0])
                sync()
                if not all(torch.equal(a[0], b) for a, b in zip(one, ref)):
                    fail(f"{name} {path} {dt}: one lane differs from the single-lane entry")
                dev_ms = graph_replay_ms(lambda: kernel(*args))
                singles_ms = graph_replay_ms(lambda: [single(*a) for a in per_lane])
                plain_ms = cuda_ms(lambda: plain(*args), 20)
                one_ms, bound_by = bound(n, m, di, d, dt, residuals)
                fig = out[name].setdefault(path, {"shape": f"L={lanes} N={n} M={m} DI={di} "
                                                           f"D={d}"})
                if dtype == torch.float32:
                    fig.update(ms=dev_ms, ms_singles=singles_ms, plain_ms=plain_ms,
                               bound_ms=lanes * one_ms, bound_by=bound_by, max_abs_err=err)
                else:
                    fig.update(ms_f64=dev_ms, ms_singles_f64=singles_ms,
                               plain_ms_f64=plain_ms, bound_ms_f64=lanes * one_ms)
                print(f"{name} {dt} {path} L={lanes} N={n} M={m} DI={di} D={d}: ok (max abs "
                      f"err {err:.3e}; one lane = the single-lane entry); device {dev_ms:.5f} "
                      f"ms (graph replay) vs {lanes} single launches {singles_ms:.5f} ms, bound "
                      f"{lanes * one_ms:.5f} ms ({bound_by}), plain {plain_ms:.4f} ms",
                      flush=True)
    return out


def lane_parity(make_model, stacked, lanes: int, ds, batch: int, seq_len: int, where: str):
    """(c) In float64 on the card: lane l of the lane-batched loss (lane
    kernels) and its gradients against the single model's loss and
    gradients of lane l's params (single kernels), each lane on its own
    batch and noise: loss rtol 1e-10, each leaf rtol 1e-6 with atol 1e-8
    times the leaf's largest entry."""
    import tempfile

    import torch

    from cbfssm_tpu_torch.training import MultiSeedTrainer

    model = make_model("float64", "pallas")
    kw = dict(dtype=torch.float64, device=DEVICE)
    u = torch.as_tensor(ds.train_in_batch[:lanes * batch], **kw).reshape(
        (lanes, batch) + ds.train_in_batch.shape[1:])
    y = torch.as_tensor(ds.train_out_batch[:lanes * batch], **kw).reshape(
        (lanes, batch) + ds.train_out_batch.shape[1:])
    w = torch.ones((lanes, batch), **kw)
    noises = [model.draw_noise(torch.Generator(DEVICE).manual_seed(40 + lane), seq_len, batch)
              for lane in range(lanes)]
    params = stacked.to(torch.float64)
    leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
        ms = MultiSeedTrainer(model, model_dir, n_seeds=lanes)
        losses = ms.lane_losses(params.with_tensors(leaves), u, y, w, noises)
    losses.sum().backward()
    worst_loss, worst_grad = 0.0, 0.0
    for lane in range(lanes):
        single = [t[lane].detach().clone().requires_grad_(True) for t in params.tensors()]
        loss, _ = model.loss(params.with_tensors(single), u[lane], y[lane], None, True, w[lane],
                             noises[lane])
        grads = torch.autograd.grad(loss, single)
        got, want = float(losses[lane].detach()), float(loss.detach())
        rel = abs(got - want) / abs(want)
        if rel > 1e-10:
            fail(f"lanes {where}: float64 loss of lane {lane}: {got!r} vs the single model's "
                 f"{want!r}")
        worst_loss = max(worst_loss, rel)
        for k, (leaf, g) in enumerate(zip(leaves, grads)):
            scale = float(g.abs().max())
            err = (leaf.grad[lane] - g).abs()
            if bool((err > 1e-6 * g.abs() + 1e-8 * scale).any()):
                fail(f"lanes {where}: float64 gradient of leaf {k}, lane {lane}: max abs err "
                     f"{float(err.max()):.3e}, largest entry {scale:.3e}")
            worst_grad = max(worst_grad, float(err.max()) / max(scale, 1e-300))
    print(f"lane parity {where}: {lanes} lanes x {len(leaves)} leaves, float64, lane-batched "
          f"vs single model: losses within {worst_loss:.3e} (rtol 1e-10), gradients within "
          f"{worst_grad:.3e} of each leaf's largest entry (rtol 1e-6)", flush=True)


def phase_sarcos_seeds(card: str, data_dir: str):
    """(b) ``vmapped_reproduction`` of the Sarcos CBFSSM at the full width
    of run_sarcos.py, float32, 'pallas', 5 seeds as lanes, one epoch cut
    to 16 steps as phase 7 cuts it, then each seed's Outputs into
    run_i/ and summary.txt. Each step launches
    ``gp_predict_residuals_lanes`` 281 times and no single kernel; each
    test batch ``gp_predict_lanes`` 281 times. (e) The median step
    against 5 x phase 7's single-seed step, peak memory, and one profiled
    step. (c) float64 lane parity. Returns the launches of the path and
    the trained stacked params."""
    import importlib.util
    import os
    import statistics
    import tempfile

    import numpy as np
    import torch

    from cbfssm_tpu_torch import run_sarcos
    from cbfssm_tpu_torch.data import Sarcos
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.outputs import Outputs
    from cbfssm_tpu_torch.outputs.summary import vmapped_reproduction
    from cbfssm_tpu_torch.training import MultiSeedTrainer

    def make_model(dtype, impl):
        return CBFSSM(dict(run_sarcos.model_config, dtype=dtype, gp_impl=impl), device=DEVICE)

    def counts():
        return (fp.fused_predict.launches, fp.fused_predict_residuals.launches,
                fp.fused_predict.lane_launches, fp.fused_predict_residuals.lane_launches)

    seq_len, batch = run_sarcos.seq_len, run_sarcos.model_config["batch_size"]
    per_batch = 2 * run_sarcos.model_config["recog_len"] + seq_len - 1
    ds = Sarcos(seq_len, run_sarcos.seq_stride, data_dir=data_dir)
    ds.train_in_batch = ds.train_in_batch[:SARCOS_STEPS * batch]
    ds.train_out_batch = ds.train_out_batch[:SARCOS_STEPS * batch]
    test_batches = -(-ds.test_in_batch.shape[0] // batch)
    steps, evals, box = [], [], {}
    step_fn, eval_fn = MultiSeedTrainer.train_step, MultiSeedTrainer._epoch_eval

    def timed_step(self, *args):
        before = counts()
        t0 = time.perf_counter()
        out = step_fn(self, *args)
        sync()
        steps.append((1e3 * (time.perf_counter() - t0),
                      tuple(a - b for a, b in zip(counts(), before))))
        box["trainer"], box["args"] = self, args
        return out

    def counted_eval(self, *args):
        before = counts()
        out = eval_fn(self, *args)
        evals.append(tuple(a - b for a, b in zip(counts(), before)))
        return out

    plots = importlib.util.find_spec("matplotlib") is not None
    saved = Outputs.training_stats, Outputs.prediction
    MultiSeedTrainer.train_step, MultiSeedTrainer._epoch_eval = timed_step, counted_eval
    if not plots:  # the card's machine has no matplotlib: the plots are skipped here only
        Outputs.training_stats = Outputs.prediction = lambda self, *a: None
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
            sync()
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            fp.fused_predict.launches = fp.fused_predict_residuals.launches = 0
            fp.fused_predict.lane_launches = fp.fused_predict_residuals.lane_launches = 0
            t0 = time.perf_counter()
            summary = vmapped_reproduction(make_model("float32", "pallas"), ds, root,
                                           SARCOS_SEEDS, 1)
            sync()
            run_s = time.perf_counter() - t0
            launches = counts()
            peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
            for it in range(SARCOS_SEEDS):
                for f in ("mse.txt", "calibration.txt", "var_dump.txt"):
                    if os.path.getsize(f"{root}/run_{it}/{f}") == 0:
                        fail(f"lanes Sarcos: run_{it}/{f} is empty")
            text = open(f"{root}/summary.txt").read()
    finally:
        MultiSeedTrainer.train_step, MultiSeedTrainer._epoch_eval = step_fn, eval_fn
        Outputs.training_stats, Outputs.prediction = saved
    trainer = box["trainer"]
    train = np.stack(trainer.train_all)
    if not (np.isfinite(train).all() and np.isfinite(np.stack(trainer.test_all)).all()):
        fail(f"lanes Sarcos: non-finite losses {trainer.train_all} / {trainer.test_all}")
    if len(np.unique(train[-1])) != SARCOS_SEEDS:
        fail(f"lanes Sarcos: the seeds' losses are not all different: {train[-1]}")
    rmse = np.asarray(summary.rmse_all)
    if rmse.shape != (SARCOS_SEEDS,) or not np.isfinite(rmse).all() or "Mean" not in text:
        fail(f"lanes Sarcos: summary RMSE {rmse} / summary.txt {text[:80]!r}")
    if len(steps) != SARCOS_STEPS or len(evals) != 1:
        fail(f"lanes Sarcos: {len(steps)} steps and {len(evals)} evaluations, want "
             f"{SARCOS_STEPS} and 1")
    for k, (_, c) in enumerate(steps):
        if c != (0, 0, 0, per_batch):
            fail(f"lanes Sarcos: step {k} launched (gp_predict, gp_predict_residuals, "
                 f"gp_predict_lanes, gp_predict_residuals_lanes) = {c}, want "
                 f"(0, 0, 0, {per_batch})")
    if evals[0] != (0, 0, test_batches * per_batch, 0):
        fail(f"lanes Sarcos: the test loss launched {evals[0]}, want (0, 0, "
             f"{test_batches} x {per_batch}, 0)")
    print(f"lanes Sarcos: vmapped_reproduction, {SARCOS_SEEDS} seeds as lanes, 1 epoch of "
          f"{SARCOS_STEPS} steps + {test_batches} test batches, then {SARCOS_SEEDS} x Outputs, "
          f"in {run_s:.2f} s; train losses {train[-1].tolist()}; RMSE {rmse.tolist()}; each "
          f"step {per_batch} gp_predict_residuals_lanes and 0 single launches, the test loss "
          f"{evals[0][2]} = {test_batches} x {per_batch} gp_predict_lanes; Outputs "
          f"{launches[0]} gp_predict; run_0..run_{SARCOS_SEEDS - 1} and summary.txt written"
          + ("" if plots else " (plots skipped: matplotlib is not installed here)"),
          flush=True)
    step_ms = statistics.median(t for t, _ in steps[1:])
    serial = STEP_MS.get("sarcos")
    print(f"train step lanes Sarcos ({SARCOS_SEEDS} seeds, B={batch} each, float32): median of "
          f"steps 2-{len(steps)} {step_ms:.2f} ms (step 1 {steps[0][0]:.2f} ms), against "
          f"{SARCOS_SEEDS} x the single-seed step {SARCOS_SEEDS * serial:.2f} ms "
          f"({serial:.2f} ms, phase 7): {SARCOS_SEEDS * serial / step_ms:.2f} x; peak allocated "
          f"{peak / 2**30:.3f} GiB over the run; {card}", flush=True)
    if DEVICE == "cuda":
        profile_step(trainer, box["args"], f"lanes Sarcos {SARCOS_SEEDS} seeds", step_ms, card)
    lane_parity(make_model, trainer.params.detach(), SARCOS_SEEDS, ds, batch, seq_len, "Sarcos")
    return launches


def phase_sweep(card: str):
    """(d) ``SweepTrainer`` on the RoboMove CBFSSM at the full width of
    run_robomove.py (B 32, M 100, S 50), float32, 'pallas', over 4 values
    of k_factor, one epoch cut to 4 steps (all 3 test batches): the lanes
    differ, the hypers are unchanged, sweep_best.json is written. Returns
    the launches of the path."""
    import json
    import statistics
    import tempfile

    import numpy as np

    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.training import SweepTrainer

    ds = robomove()
    ds.train_in_batch = ds.train_in_batch[:SWEEP_STEPS * BATCH]
    ds.train_out_batch = ds.train_out_batch[:SWEEP_STEPS * BATCH]
    grid = np.asarray(SWEEP_K_FACTOR)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
        sweep = SweepTrainer(CBFSSM, config("float32", "pallas"), {"k_factor": grid},
                             model_dir, device=DEVICE)
        step, times = sweep.train_step, []

        def timed_step(*args):
            t0 = time.perf_counter()
            out = step(*args)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
            return out

        sweep.train_step = timed_step
        fp.fused_predict.launches = fp.fused_predict_residuals.launches = 0
        fp.fused_predict.lane_launches = fp.fused_predict_residuals.lane_launches = 0
        t0 = time.perf_counter()
        sweep.train(ds, epochs=1)
        sync()
        run_s = time.perf_counter() - t0
        launches = (fp.fused_predict.launches, fp.fused_predict_residuals.launches,
                    fp.fused_predict.lane_launches, fp.fused_predict_residuals.lane_launches)
        with open(f"{model_dir}/sweep_best.json") as f:
            best = json.load(f)
    final = sweep.train_all[-1]
    if not np.isfinite(final).all() or len(np.unique(final)) != len(grid):
        fail(f"sweep: the lanes' losses are not finite and distinct: {final}")
    hyper = sweep.params.hyper["k_factor"].cpu().numpy()
    if not np.array_equal(hyper, grid.astype(np.float32)):
        fail(f"sweep: the k_factor lanes changed: {hyper} vs {grid}")
    if best != sweep.best_config() or best["k_factor"] not in SWEEP_K_FACTOR:
        fail(f"sweep: sweep_best.json {best} vs best_config {sweep.best_config()}")
    want = (0, 0, 3 * STEPS_PER_CHUNK, SWEEP_STEPS * STEPS_PER_CHUNK)
    if launches != want:
        fail(f"sweep: launches (gp_predict, gp_predict_residuals, gp_predict_lanes, "
             f"gp_predict_residuals_lanes) = {launches}, want {want}")
    print(f"sweep RoboMove CBFSSM: k_factor {list(SWEEP_K_FACTOR)} as {len(grid)} lanes, "
          f"{SWEEP_STEPS} steps + 3 test batches in {run_s:.2f} s; train losses "
          f"{final.tolist()}; k_factor lanes unchanged; sweep_best.json {best}; launches "
          f"{launches[3]} = {SWEEP_STEPS} x {STEPS_PER_CHUNK} gp_predict_residuals_lanes, "
          f"{launches[2]} = 3 x {STEPS_PER_CHUNK} gp_predict_lanes; median of steps "
          f"2-{len(times)} {statistics.median(times[1:]):.2f} ms (step 1 {times[0]:.2f} ms); "
          f"{card}", flush=True)
    return launches


def value_dispatch(card: str):
    """(f) The host cost of the value path's autograd Function: B = 1
    ``BucketedPredictor`` requests of the RoboMove CBFSSM (float32,
    'pallas') with plain calls going straight to the kernel wrapper, as
    they do, against every call forced through ``FusedPredictValue``
    (``fused_predict._batched`` patched to answer True), alternated over
    7 requests each after one warm-up each; then 2,000 back-to-back
    ``fused_predict`` calls at N 50 M 100 DI 6 D 4 each way."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.serving import BucketedPredictor
    from cbfssm_tpu_torch.utils.kernel_timing import kernel_inputs

    u_all, y_all = served_windows()
    model = CBFSSM(config("float32", "pallas"), device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    pred = BucketedPredictor(model, params, SEQ_LEN, buckets=BUCKETS)
    args = kernel_inputs(np.random.default_rng(5), 50, 100, 6, 4, torch.float32, DEVICE)
    hooks = {"direct": fp._batched, "Function": lambda _args: True}
    request_ms, call_us = {k: [] for k in hooks}, {}
    try:
        for rep in range(8):
            for label, hook in hooks.items():
                fp._batched = hook
                t0 = time.perf_counter()
                pred(u_all[:1], y_all[:1])
                if rep:  # the first request of each is a warm-up
                    request_ms[label].append(1e3 * (time.perf_counter() - t0))
        with torch.inference_mode():
            for label, hook in hooks.items():
                fp._batched = hook
                fp.fused_predict(*args)
                sync()
                t0 = time.perf_counter()
                for _ in range(2000):
                    fp.fused_predict(*args)
                sync()
                call_us[label] = 1e6 * (time.perf_counter() - t0) / 2000
    finally:
        fp._batched = hooks["direct"]
    med = {k: sorted(v)[len(v) // 2] for k, v in request_ms.items()}
    print(f"value dispatch CBFSSM B=1: median request {med['direct']:.2f} ms with plain calls "
          f"direct vs {med['Function']:.2f} ms through FusedPredictValue (7 requests each, "
          f"alternated: {', '.join(f'{t:.2f}' for t in request_ms['direct'])} / "
          f"{', '.join(f'{t:.2f}' for t in request_ms['Function'])}); per fused_predict call "
          f"{call_us['direct']:.2f} us vs {call_us['Function']:.2f} us (2,000 calls each); "
          f"{card}", flush=True)


def stacked_init(model, lanes: int):
    """The params of ``model.init`` from seeds 0..lanes-1, stacked."""
    import torch

    per_lane = [model.init(torch.Generator(device=DEVICE).manual_seed(lane))
                for lane in range(lanes)]
    return per_lane[0].with_tensors([torch.stack(ts) for ts in
                                     zip(*(p.tensors() for p in per_lane))])


def phase_lanes(card: str):
    """Phase 8: the lane kernels, the Sarcos seeds as lanes, the lane
    parity of Sarcos, of the RoboMove CBFSSM and of the RoboMove
    CBFSSMHALF ('rnn'), the RoboMove sweep and the value path's
    dispatch cost."""
    import tempfile

    import numpy as np

    from cbfssm_tpu_torch.data import synthetic
    from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF

    lane_kernels = phase_lane_kernels()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as data_dir:
        synthetic.stage_all(data_dir, seed=0)
        lanes = phase_sarcos_seeds(card, data_dir)

    def make_cbfssm(dtype, impl):
        return CBFSSM(config(dtype, impl), device=DEVICE)

    def make_half(dtype, impl):
        return CBFSSMHALF(config(dtype, impl, var_y=np.asarray([1.0**2] * 2),
                                 recog_model="rnn"), device=DEVICE)

    ds = robomove()
    lane_parity(make_cbfssm, stacked_init(make_cbfssm("float64", "pallas"), len(SWEEP_K_FACTOR)),
                len(SWEEP_K_FACTOR), ds, BATCH, SEQ_LEN, "RoboMove CBFSSM")
    lane_parity(make_half, stacked_init(make_half("float64", "pallas"), 3), 3, ds, BATCH,
                SEQ_LEN, "RoboMove CBFSSMHALF rnn")
    sweep = phase_sweep(card)
    value_dispatch(card)
    return lane_kernels, {"lanes": lanes, "sweep": sweep}


class _NoPlot:
    """Stands in for pyplot where matplotlib is not installed: every
    call does nothing, so the Outputs still run each prediction (and
    write their .mat files and text) and only the PDFs are missing."""

    def __getattr__(self, _name):
        return lambda *args, **kwargs: None


def cbfssm_predict_launches(t_len: int, recog_len: int) -> int:
    """``gp_predict`` launches of one CBFSSM predict over ``t_len``
    steps: 2 * recog_len blocked recognition steps, then t_len - 1
    forward steps."""
    if t_len <= 2 * recog_len:
        fail(f"a {t_len}-step predict runs the sequential recognition; only the blocked "
             "schedule is counted here")
    return 2 * recog_len + t_len - 1


def outputs_launches(ds, recog_len: int) -> int:
    """``gp_predict`` launches of ``OutputsRoboMove.create_all``: two
    300-step predictions (train, test), one over every test experiment
    (mse and calibration share it) and two 300-step trajectories."""
    window = cbfssm_predict_launches(min(ds.train_in.shape[1], SEQ_LEN), recog_len)
    return (4 * window + ds.test_in.shape[0]
            * cbfssm_predict_launches(ds.test_in.shape[1], recog_len))


def _read_lines(stream, lines):
    for line in iter(stream.readline, ""):
        lines.put(line)
    lines.put(None)


def cli_serve_subprocess(model_dir: str, u, y, direct, card: str) -> int:
    """(e) ``serve <dir> --port 0`` in its own process through
    ``__main__.main`` (the SIGTERM handler needs the main thread): the
    banner, one JSON request (held against the direct call of dispatch 0
    at float32 tolerance: another process), then SIGTERM must end it
    with exit 0. Returns the ``gp_predict`` launches it printed."""
    import os
    import queue
    import signal

    import numpy as np

    prog = ("import sys\n"
            "from cbfssm_tpu_torch.__main__ import main\n"
            "from cbfssm_tpu_torch.ops import fused_predict as fp\n"
            "rc = main(sys.argv[1:])\n"
            "print('launches', fp.fused_predict.launches, fp.fused_predict_residuals.launches,"
            " flush=True)\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    err_log = open(os.path.join(model_dir, "serve_stderr.txt"), "w+")
    dev = [] if DEVICE == "cuda" else ["--device", DEVICE]  # a CPU rehearsal passes its device
    proc = subprocess.Popen([sys.executable, "-c", prog, "serve", model_dir, "--port", "0", *dev],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=err_log, text=True)

    def stderr_tail():
        err_log.seek(0)
        return err_log.read()[-2000:]

    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=_read_lines, args=(proc.stdout, lines), daemon=True).start()
    try:
        try:
            banner = lines.get(timeout=300)
        except queue.Empty:
            banner = None
        if not banner or "http://" not in banner:
            proc.kill()
            proc.wait(timeout=60)
            fail(f"CLI serve: no banner ({banner!r}); stderr: {stderr_tail()}")
        ready_s = time.perf_counter() - t0
        base = banner.strip().rsplit(" ", 1)[1]
        t1 = time.perf_counter()
        code, reply = http_json("POST", base + "/v1/predict", {"u": u.tolist(), "y": y.tolist()})
        first_ms = 1e3 * (time.perf_counter() - t1)
        if code != 200:
            fail(f"CLI serve: predict answered {code}: {reply}")
        err = max(float(np.abs(np.asarray(reply[f]) - getattr(direct, f)[0]).max())
                  for f in ("pred_mean", "pred_var"))
        if not np.allclose(reply["pred_mean"], direct.pred_mean[0], rtol=1e-5, atol=1e-6):
            fail(f"CLI serve: reply differs from the direct call by {err:.3e}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        rest = []
        while (line := lines.get(timeout=30)) is not None:
            rest.append(line)
        if rc != 0 or not any("shutting down" in ln for ln in rest):
            fail(f"CLI serve: exit {rc} after SIGTERM; stdout {rest}; stderr {stderr_tail()}")
        counts = next(ln for ln in rest if ln.startswith("launches")).split()[1:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        err_log.close()
    launches, residual = int(counts[0]), int(counts[1])
    print(f"CLI serve: {banner.strip()}; ready in {ready_s:.2f} s, first request "
          f"{first_ms:.2f} ms (max abs diff to the direct call {err:.3e}); SIGTERM: exit 0, "
          f"'shutting down'; gp_predict launches {launches}, gp_predict_residuals {residual}; "
          f"{card}", flush=True)
    if residual != 0:
        fail(f"CLI serve: gp_predict_residuals launched {residual} times, want 0")
    return launches


def http_json(method: str, url: str, body=None, timeout: float = 300):
    """(status, parsed JSON reply) of one request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method)
    data = None
    if body is not None:
        data = json.dumps(body).encode()
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, data=data, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_serve(model_dir: str, u_all, y_all, card: str):
    """(d) An in-process ``PredictionServer`` over
    ``load_trained_model(dir)`` (buckets 1, 8, 32; the server's default
    2 ms coalescing window): one request and then 32 concurrent
    single-window requests, in JSON and in ``.npz``, then ``/v1/params``
    with the last checkpoint and one request of each body. Every reply
    must equal the direct ``BucketedPredictor`` call of its dispatch
    (the batch it was coalesced into, generator seed ``fold_seed(0, k)``,
    the params then served) exactly; every dispatch launches
    ``gp_predict`` 399 times. Returns the launches."""
    import statistics

    import numpy as np
    import torch

    from cbfssm_tpu_torch import model_store
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.serving import BucketedPredictor, MicroBatcher, fold_seed
    from cbfssm_tpu_torch.serving_http import PredictionServer, post_params_npz, post_predict_npz
    from cbfssm_tpu_torch.training import checkpoint

    model, params = model_store.load_trained_model(model_dir, device=DEVICE)
    _, last = model_store.load_trained_model(model_dir, checkpoint.LAST, device=DEVICE)
    seq_len = model_store.load_model_meta(model_dir)["dataset"]["seq_len"]
    dispatched = []

    class Recording(BucketedPredictor):
        def __call__(self, u, y, seed=None):
            dispatched.append((u, y, seed, self.params))
            return super().__call__(u, y, seed)

    served = Recording(model, params, seq_len, buckets=BUCKETS)
    served(u_all[:1], y_all[:1])  # first request: allocator and cuBLAS set-up
    dispatched.clear()
    sync()
    # where a B = 1 request's time goes, on the last 6 windows: the
    # predictor called directly, then through a MicroBatcher
    plain = BucketedPredictor(model, params, seq_len, buckets=BUCKETS)

    def timed_ms(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return 1e3 * (time.perf_counter() - t0)

    last6 = len(u_all) - 6
    direct_ms = statistics.median(timed_ms(plain, u_all[last6 + k:last6 + k + 1],
                                           y_all[last6 + k:last6 + k + 1]) for k in range(3))
    with MicroBatcher(plain) as mb:
        batcher_ms = statistics.median(timed_ms(mb, u_all[last6 + 3 + k], y_all[last6 + 3 + k])
                                       for k in range(3))
    replies, lat = [], {}
    with PredictionServer(served, port=0) as srv:
        srv.start()
        base = f"http://{srv.host}:{srv.port}"

        def one(i, binary):
            t0 = time.perf_counter()
            if binary:
                out = post_predict_npz(base, u_all[i], y_all[i], timeout=300)
            else:
                code, out = http_json("POST", base + "/v1/predict",
                                      {"u": u_all[i].tolist(), "y": y_all[i].tolist()})
                if code != 200:
                    fail(f"HTTP serve: request {i} answered {code}: {out}")
            return i, out, 1e3 * (time.perf_counter() - t0)

        def wave(first, binary):
            res = [None] * 32
            barrier = threading.Barrier(32)

            def client(k):
                barrier.wait(timeout=300)
                res[k] = one(first + k, binary)

            before = srv.stats()["batches"]
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(k,)) for k in range(32)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = 1e3 * (time.perf_counter() - t0)
            if any(r is None for r in res):
                fail("HTTP serve: a concurrent request got no reply")
            return res, wall, srv.stats()["batches"] - before

        fp.fused_predict.launches = 0
        fp.fused_predict_residuals.launches = 0
        # a window of its own for every request: a reply is matched to its
        # dispatch by its window
        for tag, binary, first in (("json", False, 0), ("npz", True, 3)):
            r = [one(first + k, binary) for k in range(3)]  # B = 1, one after another
            replies += r
            lat[f"{tag} B=1"] = statistics.median(t for *_, t in r)
        for tag, binary, first in (("json", False, 6), ("npz", True, 38)):
            res, wall, n_disp = wave(first, binary)
            replies += res
            lat[f"{tag} B=32"] = (wall, n_disp, statistics.median(t for *_, t in res))
        t0 = time.perf_counter()
        post_params_npz(base, last, timeout=300)
        swap_ms = 1e3 * (time.perf_counter() - t0)
        replies += [one(70, False), one(71, True)]
        stats = srv.stats()
    launches, residual = fp.fused_predict.launches, fp.fused_predict_residuals.launches
    if residual != 0:
        fail(f"HTTP serve: gp_predict_residuals launched {residual} times, want 0")
    if launches != STEPS_PER_CHUNK * len(dispatched):
        fail(f"HTTP serve: gp_predict launches {launches} != {STEPS_PER_CHUNK} x "
             f"{len(dispatched)} dispatches")
    if [d[2] for d in dispatched] != [fold_seed(0, k) for k in range(len(dispatched))]:
        fail("HTTP serve: dispatch k did not run with generator seed fold_seed(0, k)")
    before, after = dispatched[:-2], dispatched[-2:]
    if not (all(d[3] is params for d in before) and all(d[3] is after[0][3] for d in after)
            and all(torch.equal(a, b) for a, b in zip(after[0][3].tensors(), last.tensors()))):
        fail("HTTP serve: the dispatches did not run on best.ckpt, then on model.ckpt")
    # the direct call of every dispatch, outside the counting window
    direct = [BucketedPredictor(model, p, seq_len, buckets=BUCKETS)(u, y, seed)
              for u, y, seed, p in dispatched]
    for i, out, _ in replies:
        k, row = next(((k, r) for k, d in enumerate(dispatched) for r in range(d[0].shape[0])
                       if np.array_equal(d[0][r], u_all[i].astype(d[0].dtype))), (None, None))
        if k is None:
            fail(f"HTTP serve: request {i} is in no dispatch")
        for f in ("pred_mean", "pred_var", "internal_mean", "internal_var", "sde"):
            if not np.array_equal(np.asarray(out[f], dtype=np.float32), getattr(direct[k], f)[row]):
                fail(f"HTTP serve: request {i} {f} differs from the direct call of dispatch {k}")
    print(f"HTTP serve: {len(replies)} requests in {len(dispatched)} dispatches ("
          f"{stats['requests']} served, max batch {stats['max_batch_seen']}), every reply equal "
          f"to the direct call of its dispatch (fold_seed(0, k)); /v1/params with model.ckpt; "
          f"gp_predict launches {launches} = {STEPS_PER_CHUNK} x {len(dispatched)}", flush=True)
    print(f"latency B=1, median of 3: BucketedPredictor called directly {direct_ms:.2f} ms, "
          f"through a MicroBatcher {batcher_ms:.2f} ms, over HTTP JSON {lat['json B=1']:.2f} "
          f"ms, .npz {lat['npz B=1']:.2f} ms; {card}", flush=True)
    for key in ("json", "npz"):
        wall, n_disp, med = lat[f"{key} B=32"]
        print(f"latency HTTP {key}: B=1 median of 3 {lat[f'{key} B=1']:.2f} ms; 32 concurrent "
              f"single-window requests {wall:.2f} ms wall in {n_disp} dispatches (median "
              f"request {med:.2f} ms); {card}", flush=True)
    print(f"hot-swap: POST /v1/params (model.ckpt, {len(last.tensors())} leaves) "
          f"{swap_ms:.2f} ms round trip; {card}", flush=True)
    return launches, model, params


def phase_cli_http(card: str):
    """Phase 9: the CLI and the HTTP server at the RoboMove phase-0 width,
    float32. (a) ``__main__.main(["reproduce", "robomove", "--epochs",
    "1", "--root", DIR])`` in this process: both curriculum phases, one
    full epoch each (16 x 399 ``gp_predict_residuals``, 3 x 399
    ``gp_predict``) and the OutputsRoboMove of each; (b) ``info DIR``;
    (c) ``eval DIR --out DIR2``, whose mse.txt must equal (a)'s; (d) the
    in-process server (:func:`http_serve`); (e) the CLI ``serve`` in a
    subprocess (:func:`cli_serve_subprocess`). Each of (a), (c), (d)
    sets the launch counts to 0 just before and reads them just after.
    Returns the launches by path."""
    import contextlib
    import importlib.util
    import io
    import os
    import tempfile

    from cbfssm_tpu_torch import __main__ as cli
    from cbfssm_tpu_torch import run_robomove
    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.outputs import outputs as outputs_mod
    from cbfssm_tpu_torch.outputs import outputs_robomove
    from cbfssm_tpu_torch.serving import BucketedPredictor, fold_seed

    recog_len = run_robomove.model_config(0)["recog_len"]
    dev = [] if DEVICE == "cuda" else ["--device", DEVICE]  # a CPU rehearsal passes its device
    ds = robomove()
    steps = -(-TRAIN_WINDOWS // BATCH)
    test_batches = -(-TEST_WINDOWS // BATCH)
    per_outputs = outputs_launches(ds, recog_len)
    plots = importlib.util.find_spec("matplotlib") is not None
    saved = outputs_mod.pyplot, outputs_robomove.pyplot
    if not plots:  # the PDFs are skipped, every prediction still runs
        outputs_mod.pyplot = outputs_robomove.pyplot = _NoPlot
    paths = {}
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            root, evaldir = os.path.join(tmp, "robomove"), os.path.join(tmp, "eval")
            fp.fused_predict.launches = 0
            fp.fused_predict_residuals.launches = 0
            t0 = time.perf_counter()
            if cli.main(["reproduce", "robomove", "--epochs", "1", "--root", root, *dev]) != 0:
                fail("CLI reproduce robomove did not return 0")
            sync()
            run_s = time.perf_counter() - t0
            paths["cli_reproduce"] = (fp.fused_predict.launches,
                                      fp.fused_predict_residuals.launches)
            want = (2 * (test_batches * STEPS_PER_CHUNK + per_outputs),
                    2 * steps * STEPS_PER_CHUNK)
            if paths["cli_reproduce"] != want:
                fail(f"CLI reproduce: (gp_predict, gp_predict_residuals) launches "
                     f"{paths['cli_reproduce']} != {want}: 2 phases x ({test_batches} test "
                     f"batches x {STEPS_PER_CHUNK} + OutputsRoboMove {per_outputs}), 2 x "
                     f"{steps} steps x {STEPS_PER_CHUNK}")
            for name in ("best.ckpt", "model.ckpt", "model_meta.json", "mse.txt",
                         "calibration.txt", "predict_test.mat"):
                if not os.path.isfile(os.path.join(root, name)):
                    fail(f"CLI reproduce: {name} was not written")
            print(f"CLI reproduce robomove: 2 curriculum phases of 1 epoch ({steps} Adam steps, "
                  f"{test_batches} test batches) and their OutputsRoboMove in {run_s:.2f} s; "
                  f"(gp_predict, gp_predict_residuals) launches {paths['cli_reproduce']} = "
                  f"2 x ({test_batches} x {STEPS_PER_CHUNK} + {per_outputs}), 2 x {steps} x "
                  f"{STEPS_PER_CHUNK}" + ("" if plots else
                                          "; PDFs skipped: matplotlib is not installed here"),
                  flush=True)

            info = io.StringIO()
            with contextlib.redirect_stdout(info):
                rc = cli.main(["info", root])
            text = info.getvalue()
            if rc != 0 or "CBFSSM (dim_u=2, dim_y=2, seed=0, ds=RoboMove)" not in text or \
                    "checkpoints: best.ckpt, model.ckpt" not in text:
                fail(f"CLI info: exit {rc}, output {text[:500]!r}")
            print(f"CLI info: {text.splitlines()[0]}; {text.splitlines()[1]}", flush=True)

            fp.fused_predict.launches = 0
            fp.fused_predict_residuals.launches = 0
            t0 = time.perf_counter()
            if cli.main(["eval", root, "--out", evaldir, *dev]) != 0:
                fail("CLI eval did not return 0")
            sync()
            eval_s = time.perf_counter() - t0
            paths["cli_eval"] = (fp.fused_predict.launches, fp.fused_predict_residuals.launches)
            if paths["cli_eval"] != (per_outputs, 0):
                fail(f"CLI eval: launches {paths['cli_eval']} != ({per_outputs}, 0)")
            with open(os.path.join(root, "mse.txt")) as a, \
                    open(os.path.join(evaldir, "mse.txt")) as b:
                mse_a, mse_b = a.read(), b.read()
            if mse_a != mse_b:
                fail(f"CLI eval: mse.txt {mse_b!r} != the reproduce run's {mse_a!r}")
            print(f"CLI eval: OutputsRoboMove from model_meta.json and best.ckpt alone in "
                  f"{eval_s:.2f} s; mse.txt equals the reproduce run's "
                  f"({' '.join(mse_a.split())}); gp_predict launches {paths['cli_eval'][0]}",
                  flush=True)

            u_all, y_all = ds.test_in_batch, ds.test_out_batch
            launches, model, params = http_serve(root, u_all, y_all, card)
            paths["http_serve"] = (launches, 0)
            direct = BucketedPredictor(model, params, SEQ_LEN, buckets=BUCKETS)(
                u_all[:1], y_all[:1], fold_seed(0, 0))
            paths["cli_serve"] = (cli_serve_subprocess(root, u_all[0], y_all[0], direct, card),
                                  0)
            if paths["cli_serve"][0] != STEPS_PER_CHUNK:
                fail(f"CLI serve: gp_predict launches {paths['cli_serve'][0]} != "
                     f"{STEPS_PER_CHUNK} (one dispatch)")
    finally:
        outputs_mod.pyplot, outputs_robomove.pyplot = saved
    return paths


def main() -> None:
    if not (ROOT / "cbfssm_tpu_torch" / "__init__.py").is_file():
        fail("cbfssm_tpu_torch/ is not beside chip_smoke.py; run from the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    t_start = time.perf_counter()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t0:.2f} s", flush=True)
        return out

    card = timed("1 device", phase_device)
    timed("2 build", phase_build)
    max_err, times = timed("3 kernel", phase_kernel)
    res_err, res_times = timed("3b residual kernel", phase_residual_kernel)
    serve_launches = timed("4 serving", phase_serving, card)
    train_launches, residual_launches = timed("5 training", phase_training, card)
    other = timed("6 CBFSSMHALF and PRSSM", phase_other_models, card)
    model_kernels, new_paths = timed("7 Voliro and Sarcos", phase_voliro_sarcos, card)
    lane_kernels, lane_paths = timed("8 lanes", phase_lanes, card)
    cli_paths = timed("9 CLI and HTTP", phase_cli_http, card)
    print(f"all phases: {time.perf_counter() - t_start:.2f} s", flush=True)
    if "jax" in sys.modules:
        fail("jax was imported")
    # launches per main path: (gp_predict, gp_predict_residuals,
    # gp_predict_lanes, gp_predict_residuals_lanes)
    paths = {"serving": (serve_launches, 0), "training": (train_launches, residual_launches),
             **other, **new_paths, **cli_paths}
    paths = {path: counts + (0, 0) for path, counts in paths.items()}
    paths.update(lane_paths)
    n, m, di, d = SHAPES["recognition N=12800 M=100 DI=6 D=2"]
    n2, m2, di2, d2 = SHAPES["forward N=1600 M=100 DI=6 D=4"]
    kernels = []
    for k, (name, line, err, t, residuals) in enumerate((
        ("gp_predict", 79, max_err, times, False),
        ("gp_predict_residuals", 85, res_err, res_times, True),
    )):
        by_path = {path: counts[k] for path, counts in paths.items()}
        bound_ms, bound_by = bound(n, m, di, d, "float32", residuals)
        bound2_ms, bound2_by = bound(n2, m2, di2, d2, "float32", residuals)
        dev_ms, k_ms, p_ms = t[(torch.float32, n)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cbfssm_tpu_torch/csrc/gp_predict.cu",
            "replaces": f"cbfssm_tpu/ops/pallas/gp_predict.py:{line}",
            "launches": sum(by_path.values()),
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
            "model_shapes": model_kernels[name],
        })
    # the lane kernels: figures at the Sarcos recognition shape of phase 8
    lanes, ln, lm, ldi, ld = LANE_SHAPES["sarcos recognition"]
    for k, name in enumerate(("gp_predict_lanes", "gp_predict_residuals_lanes"), start=2):
        by_path = {path: counts[k] for path, counts in paths.items() if counts[k]}
        fig = lane_kernels[name]["sarcos recognition"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cbfssm_tpu_torch/csrc/gp_predict.cu",
            "replaces": f"cbfssm_tpu/ops/pallas/gp_predict.py:{(79, 85)[k - 2]} (batched "
                        "over lanes by jax.vmap)",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(f["max_abs_err"] for f in lane_kernels[name].values()),
            "ms": fig["ms"],
            "plain_ms": fig["plain_ms"],
            "bound_ms": fig["bound_ms"],
            "bound_by": fig["bound_by"],
            "library_ms": None,
            "shape": f"float32 L={lanes} N={ln} M={lm} DI={ldi} D={ld}",
            "ms_singles": fig["ms_singles"],
            "lane_shapes": lane_kernels[name],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
