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
   and one further step of each under ``torch.profiler`` (here through
   the port's ``utils.profiling.trace``): device kernels, their summed
   time, the busy share and the largest kernels. Then the hand adjoint:
   one float32 epoch with ``adjoint='hand'``, ``gp_impl='solve_free'``
   (no kernel of the four launches), whose first step's loss must equal
   the solve_free autodiff epoch's bitwise; on one batch the loss
   bitwise and every gradient leaf against autodiff (float64 rtol 1e-7 /
   atol 1e-12, float32 rtol 2e-3 / atol 1e-5); its step time, peak
   memory, kernels and busy share beside pallas- and solve_free-autodiff.
   Then the Trainer's Adam update against ``torch.optim.Adam``'s step on
   copies of the trained leaves: host ms and kernels of an update, and
   the leaves within 1e-5 of their largest entry after 24 updates. Last,
   ``Trainer(profile_dir=)`` on a cut run (windows of 60 steps, 2 epochs
   of 2 steps and 1 test batch): one trace file holding the 2 x 119
   ``gp_predict_residuals`` kernel events of epoch 1, and the losses of
   the same run without it;
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
   10, recog_len 16), float32, cut to 8 Adam steps: 281 launches per
   step and per test batch. For both, the two gp_impl paths on one
   batch with fixed noise (float64 loss rtol 1e-10, every gradient leaf
   rtol 1e-6, predict outputs rtol 1e-8; float32 against float64 on the
   loss terms at rtol 1e-3), the step time, peak memory and one
   profiled step. Then Voliro's ``adjoint='parallel'``
   (``gp_impl='solve_free'``): loss bitwise and every gradient leaf
   against autodiff in float64 (rtol 1e-7 / atol 1e-11), and 10 float32
   steps of each schedule from the trained params, with step time, peak
   memory and kernels per step; the parallel steps launch no kernel of
   the four;
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
   'pallas', on phase 7's synthetic file with the epoch cut to 8 steps:
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
   (g) one lane-batched gradient step of the RoboMove CBFSSM with
   ``adjoint='hand'`` against autodiff (``gp_impl='solve_free'``, 2
   lanes of 8 windows, cut from the sweep's 4 x 32): float64 lane
   losses bitwise and gradients at rtol 1e-7 / atol 1e-12, float32 step
   times; the hand steps launch no kernel of the four;
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
   in a subprocess: one request, then SIGTERM must end it with exit 0;
10. online filtering, with CBFSSMHALF ('rnn') at the RoboMove phase-0
   width (S 50, M 100, dim_x 4, float32, ``gp_impl='pallas'``, phase 6's
   trained params) on RoboMove test windows: (a) ``StreamingFilter(batch=1,
   replay_buckets=(16, 64))``: start, 64 updates, a 50-step forecast,
   and a 64-step replay from the restored start state, equal to the
   updates bitwise (float32) and at rtol 1e-12 in float64; (b) a
   ``FilterPool(capacity=32)`` (N = 1,600 rows a tick): 32 attaches, 20
   lockstep ticks equal to a ``StreamingFilter(batch=32)`` from the same
   ensemble, a hold tick, a ragged replay (lengths uniform in [1, 64],
   seed 0) equal to the tick-by-tick schedule, a 50-step forecast, the
   state restored into a pool of another seed with the next 3 ticks
   equal, and the kernel path against ``solve_free`` in float64 (rtol
   1e-8); (c) an in-process ``FilterServer`` answering 16 client threads
   x 20 ``POST /v1/sessions/<sid>/step`` under a 10 ms window, every
   reply equal to a bare pool replaying the recorded dispatches; ``GET
   /v1/state`` in JSON and ``.npz`` restored into a standby of another
   seed whose next tick is equal; a ``/v1/params`` swap that keeps the
   sessions; (d) a ``FilterServer(capacity=1024)`` (N = 51,200 rows)
   filled by ``POST /v1/state`` of (b)'s ensembles tiled 32 times, the
   four ``/v1/state`` transfers timed, 5 ticks of all 1,024 sessions,
   every reply equal to a bare pool loaded with the same snapshot and
   replaying the recorded dispatches, and ``gp_predict`` against its plain version at the filter shapes
   (``kernel_timing.FILTER_SHAPES``, N = 51,200 among them) timed by
   graph replay beside its bound; (e) ``serve --filter DIR --port 0`` in a
   subprocess: an attach and a step, then SIGTERM must give exit 0; on a
   CBFSSM directory ``serve --filter`` must exit 2; (f) Voliro
   (run_voliro.py's config with ``filter_dt`` 0.01, on a synthetic flip
   log): a ``StreamingFilter`` and a ``FilterPool(capacity=8)``, a replay
   equal to the updates, the kernel path against ``solve_free`` in
   float64. Every tick launches ``gp_predict`` once, a forecast H times,
   a replay chunk as often as its padded length; ``filter_init`` none.
11. deployment artifacts, at the RoboMove phase-0 width, float32,
   ``gp_impl='pallas'``, its depth cut for time (``EXPORT_SEQ``,
   ``EXPORT_H``, ``EXPORT_REPLAY``): (a) ``save_exported_predictor`` of
   phase 4's CBFSSM (seed-0 init) at B 1, seq 120, its export and save
   seconds; loaded through ``ExportedBatchPredictor``, which compiles it
   (``torch.compile``) on a fresh compile cache: the cold load's seconds,
   and a warm load's in a new process on the same cache, which must hit
   it; the program holds 219 ``cbfssm_torch::gp_predict`` nodes
   (``cbfssm_predict_launches(120, 50)``), 5 compiled calls at seeds 0-4
   launch 5 x 219, each reply within rtol 2e-5 of ``CompiledPredictor``'s
   at the seed and of the uncompiled program's, which equals
   ``CompiledPredictor``'s bitwise; request ms of the three in turns;
   (a') a float64 artifact at the full width, recog_len 5 and seq 12,
   compiled, within rtol 1e-12 of the live predictor and the uncompiled
   program; (b) ``serve <artifact>`` in a subprocess on the warm cache:
   2 requests, each equal to this process's compiled
   artifact at the dispatch seed bitwise, 3 x 219 launches (its load's
   call and the 2 requests); (c) ``python -m
   cbfssm_tpu_torch export DIR --kind pool`` in a subprocess started
   after phase 6 (beside phases 7-10) on a directory of phase 6's
   CBFSSMHALF (capacity 32, horizon 10,
   replay bucket 16), loaded as an ``ExportedFilterPool``: 32
   attaches, 64 ticks, a forecast and a ragged replay of 1..16 steps
   (64 + 10 + 16 launches, 1 per tick, H per forecast, the padded length
   per chunk),
   every output equal to a live ``FilterPool``'s bitwise, failover live
   -> artifact and artifact -> live (3 ticks each, bitwise), and ``serve
   <artifact> --filter`` in a subprocess (an attach and a step, 1
   launch); (d) the ``BucketedPredictor`` cost fit over B = 1, 2, 4, 8,
   16, 32 that gives the planner's ``MEASURED_COST``; and the host
   cost per call of the custom op against the direct wrapper.
12. process groups (``cbfssm_tpu_torch.parallel``), CBFSSM at the
   RoboMove width in float64, ``gp_impl='pallas'``, on windows cut to 64
   train (2 Adam steps of 32) and 32 test (1 batch): (a) a one-rank NCCL
   group in this process: ``Trainer(mesh=process_mesh((1,), ('data',)))``
   bitwise equal to the meshless epoch in losses and params; (b) a gloo
   group of 2 spawned ranks on the one card (NCCL takes one rank a GPU;
   a ``FileStore`` under ``build/``): the ``Trainer(mesh=make_mesh())``
   epoch at 16 rows a rank, losses and params within rtol 1e-10 of (a)'s
   meshless run and params bitwise equal across ranks; a
   ``ParticleParallel`` loss and gradient on a particle mesh of 2 (S 25
   a rank) against the serial emulation in this process (rtol 1e-10);
   a 2-lane ``MultiSeedTrainer(mesh=)`` epoch (1 lane a rank, 1 step)
   against the unsharded 2 lanes (rtol 1e-10); the census of one meshed
   step (one all-reduce of the parameter bytes, one of the scalars) and
   of one lane step (none). Per rank it prints the step ms and the
   gradient all-reduce ms. A rank that fails, dies or hangs fails the
   phase.
13. last modules: (a) ``FilterPool(mesh=local_mesh(...))`` at phase
   10's width (CBFSSMHALF 'rnn', float32, 'pallas', phase 6's params),
   capacity 1,024 (N 51,200 rows a tick unsharded): 32 attached
   sessions tiled to 1,024 load into the unsharded pool, whose state
   loads into pools over ``local_mesh(["cuda:0"])``,
   ``(["cuda:0"] * 2)`` and, with more than one card visible, every
   card; each runs 8 ticks with one session held, a forecast of every
   session at H 50 and a ragged replay of 1..64 steps, all outputs and
   the state bitwise equal to the unsharded pool's, launches = blocks x
   the unsharded pool's (8 + 50 + 64), no collective (``parallel.census``);
   tick ms of each pool; (b) fused multi-epoch dispatch, phase 12's
   cut windows in float32: 5 epochs of ``Trainer`` and 3 of a 2-lane
   ``MultiSeedTrainer`` at ``epochs_per_dispatch`` 1 and 2 (after a
   1-epoch warm-up run each), every block under
   ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside a
   block fails), losses and the best and last checkpoints (and the
   stacked ones) bitwise equal, launches equal; epoch ms of each; (c)
   the native host loader loads (it fails if ``native.available()`` is
   false), its ``window_gather`` of the float64 RoboMove series equals
   numpy's gather bitwise and ``unwrap_euler_angles`` through it equals
   its Python loop bitwise; each pair timed;
14. the bench (``cbfssm_tpu_torch.bench``, ``gp_impl='solve_free'``):
   the headline Voliro parts on the card (B 16, seq 64, S 20, M 20,
   float32), one bench step (loss and gradient) on the card against the
   same step on the CPU from the same params and the same noise, drawn
   on the CPU: loss rtol 1e-5, each gradient leaf's largest |a - b| at
   most 1e-3 of its largest |b| (the observed ratios are printed);
   ``bench.measure(steps=3, warmup=2)`` gives a finite positive rate;
   the result line carries ``device``. It launches none of the four
   kernels and is not one of the main paths below; no CPU baseline,
   300-step chunk, Trainer or multi-seed stage runs here.

Each phase prints its seconds. The main paths are phases 4, 5 and 6's
four, phase 5's ``training_hand`` and ``trainer_profile``, phase 7's
three (``voliro``: training, test loss and outputs;
``voliro_parallel``; ``training_sarcos``), phase 8's three (``lanes``:
the Sarcos seeds' training, test loss and outputs; ``sweep``;
``lanes_hand``) and phase 9's four
(``cli_reproduce``, ``cli_eval``, ``http_serve``, and ``cli_serve``,
counted by the subprocess itself) and phase 10's six
(``filter_stream``, ``filter_pool``, ``filter_http``,
``filter_fleet_1024``, ``cli_serve_filter`` and ``filter_voliro``) and
phase 11's four (``export_predictor``, ``cli_serve_artifact``,
``export_pool`` and ``cli_serve_pool``, the two served ones counted by
their subprocesses) and phase 12's four (``dp_nccl_1``; and per rank,
held on both ranks and listed from rank 0, ``dp_gloo_2``,
``particle_gloo_2`` and ``lanes_mesh_2``) and phase 13's seven
(``pool_unsharded``, ``pool_mesh_1``, ``pool_mesh_2``, and with more
cards ``pool_mesh_<n>gpu``; ``train_epd1``, ``train_epd2``,
``lanes_epd1``, ``lanes_epd2``):
each sets the launch counts of all four kernels to 0 just before it
(``reset_launches``) and reads all four just after (``launch_counts``),
and the kernels line lists them by path (``launches_by_path``;
``launches`` is their sum). The three paths on ``gp_impl='solve_free'``
(``SOLVE_FREE_PATHS``) launch none of the four kernels, and are listed
with their zeros.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the card, and the line before that lists the kernels with their
checks and times: ``ms`` is the graph-replayed device time at the
recognition shape (float32, N = 12,800), ``ms_n1600`` the same at the
forward shape (N = 1,600), each beside its bound (``bound_ms``,
``bound_ms_n1600``); ``eager_ms`` is the back-to-back figure,
``device_ms_f64`` has the same device times in float64,
``model_shapes`` the figures of phase 7's four shapes, and for
``gp_predict`` ``ms_n51200`` / ``bound_ms_n51200`` the 1,024-session
fleet's shape and ``filter_shapes`` the figures of phase 10's four,
``op_host_us`` phase 11's host cost of the op and of the wrapper and
``bucket_cost_fit`` its fit. The two lane
kernels follow, with their figures at the Sarcos recognition shape of
phase 8 (``ms_singles``: the same work as L single launches) and
``lane_shapes`` for all five.
"""

from __future__ import annotations

import contextlib
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
SHAPES = {
    "recognition N=12800 M=100 DI=6 D=2": (12800, 100, 6, 2),
    "forward N=1600 M=100 DI=6 D=4": (1600, 100, 6, 4),
    "ragged N=37 M=11 DI=5 D=3": (37, 11, 5, 3),
}
TIMED_N = (12800, 1600)  # the RoboMove shapes, timed by graph replay
# (DI, D) of the Voliro force and recognition GPs and the Sarcos
# recognition and forward GPs
MODEL_WIDTHS = ((12, 3), (19, 6), (21, 7), (21, 14))
SARCOS_STEPS = 8  # Adam steps of phase 7's Sarcos epoch (a full one is 120)
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
PROFILE_SEQ = 60  # phase 5's Trainer(profile_dir=) windows: a sequential recognition
HAND_LANES, HAND_LANE_BATCH = 2, 8  # phase 8 (g), cut from the sweep's 4 lanes at B 32
# the paths on gp_impl='solve_free': their rule is no launch of any kernel
SOLVE_FREE_PATHS = ("training_hand", "voliro_parallel", "lanes_hand")
FILTER_TICKS = 64  # phase 10 (a): updates of the one stream, and its replayed backlog
FORECAST_H = 50
REPLAY_BUCKETS = (16, 64)
FLEET, FLEET_TICKS = 32, 20  # (b)
HTTP_CLIENTS, HTTP_TICKS, HTTP_WAIT_MS = 16, 20, 10.0  # (c)
BIG_FLEET, BIG_FLEET_TICKS = 1024, 5  # (d)
VOLIRO_POOL = 8  # (f)
EXPORT_REQUESTS = 5  # phase 11 (a): artifact calls held against the live predictor
FIT_BUCKETS, FIT_REPEATS = (1, 2, 4, 8, 16, 32), 15  # (d)
OP_CALLS = 2000  # the op's host cost
# phase 11's depth, cut for time from the served shapes (seq 300, H 50,
# replay 64): tracing a program takes time in proportion to its steps
EXPORT_SEQ, EXPORT_H, EXPORT_REPLAY = 120, 10, 16
EXPORT_SEQ_F64, EXPORT_RECOG_F64 = 12, 5  # phase 11 (a'): the float64 artifact's depth


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


COUNTERS = "(gp_predict, gp_predict_residuals, gp_predict_lanes, gp_predict_residuals_lanes)"


def reset_launches():
    """Sets the launch counts of all four kernel wrappers to 0."""
    from cbfssm_tpu_torch.ops import fused_predict as fp

    sync()
    fp.fused_predict.launches = fp.fused_predict_residuals.launches = 0
    fp.fused_predict.lane_launches = fp.fused_predict_residuals.lane_launches = 0


def launch_counts() -> tuple:
    """The launches of all four kernels (in the order of ``COUNTERS``)
    since :func:`reset_launches`."""
    from cbfssm_tpu_torch.ops import fused_predict as fp

    sync()
    return (fp.fused_predict.launches, fp.fused_predict_residuals.launches,
            fp.fused_predict.lane_launches, fp.fused_predict_residuals.lane_launches)


def read_launches(where: str, want, rule: str) -> tuple:
    """The four launch counts since :func:`reset_launches`; fails unless
    they equal ``want``: a 4-tuple, or the ``gp_predict`` count with
    the other three kernels not launched."""
    counts = launch_counts()
    if isinstance(want, int):
        want = (want, 0, 0, 0)
    if counts != want:
        fail(f"{where}: {COUNTERS} launches {counts} != {want} = {rule}")
    return counts


def bound(n, m, di, d, dtype: str, residuals: bool):
    """(ms, 'operations' | 'bytes'): the least time the card could take
    for one predict. Operations per row: the cross-Gram 2*M*DI, the
    M-long epilogues (~9 M), w = kmn @ kinv 2*M^2, mean and the variance
    product 4*M*D; bytes: each input read once, each output written
    once (with residuals also kmn and w, [N, M] each), over the card's
    peaks (``kernel_timing.PEAK_FLOPS``, ``PEAK_BYTES``)."""
    from cbfssm_tpu_torch.utils.kernel_timing import PEAK_BYTES, PEAK_FLOPS

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
    # matmul is set only if TF32 is on: PyTorch's default (off) is part of
    # the compile cache's key, which phase 11's processes share with this one
    if torch.backends.cuda.matmul.allow_tf32:
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
    ``steps_per_chunk`` times, and no other kernel runs. Returns the
    four launch counts."""
    from cbfssm_tpu_torch.serving import BucketedPredictor, MicroBatcher

    bp = BucketedPredictor(model, params, SEQ_LEN, buckets=BUCKETS)
    bp(u_all[:1], y_all[:1])  # first request: cuBLAS / allocator set-up
    reset_launches()
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
    dispatches = stats["batches"] + 2
    counts = read_launches(where, steps_per_chunk * dispatches,
                           f"{steps_per_chunk} x {dispatches} dispatches")
    launches = counts[0]
    for i, out in enumerate(results):
        if out is None:
            fail(f"{where}: request {i} got no result")
        check_output(out, 1, f"{where} MicroBatcher request {i}")
    check_output(chunked, 40, f"{where} chunked request")
    print(f"serving {where}: {n_req} MicroBatcher requests from {n_threads} threads in "
          f"{stats['batches']} batches (max {stats['max_batch_seen']}), one 40-row "
          f"request in 2 chunks; {launches} kernel launches = {steps_per_chunk} x "
          f"{dispatches} dispatches; outputs finite", flush=True)
    return counts


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
    counts = serve_main_path(model, params, u_all, y_all, STEPS_PER_CHUNK, "CBFSSM")
    predict_parity(make_model, params, u_all[:8], y_all[:8], "CBFSSM")
    request_latency(make_model, params, u_all, y_all, ("pallas", "solve_free"), card, "CBFSSM")
    return counts


def timed_train(model, model_dir, ds):
    """``Trainer(model, model_dir, seed=0).train(ds, epochs=1)`` with each
    ``train_step`` timed on the host clock, each ending in a device
    sync. Returns the trainer, the step times (ms), the peak allocated
    device memory of the epoch and the last step's arguments; the
    trainer's ``step_losses`` holds each step's loss."""
    import torch

    from cbfssm_tpu_torch.training import Trainer

    trainer = Trainer(model, model_dir, seed=0)
    step, times, last = trainer.train_step, [], []
    trainer.step_losses = []

    def timed_step(*args):
        t0 = time.perf_counter()
        out = step(*args)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        last[:] = [args]
        trainer.step_losses.append(float(out[0]))
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


def profile_step(trainer, args, label: str, step_ms: float, card: str, top: int = 8,
                 via_trace: bool = False):
    """One more ``train_step`` on ``args`` under ``torch.profiler`` (with
    ``via_trace`` under the port's ``utils.profiling.trace``, whose file
    goes to a temporary directory): its device kernels, their summed
    time (one stream, so the busy time), the busy share of the median
    step ``step_ms`` and the largest kernels by device time. Returns
    (kernels, busy ms)."""
    import collections
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cbfssm_tpu_torch.utils.profiling import trace

    with contextlib.ExitStack() as stack:
        if via_trace:
            log_dir = stack.enter_context(tempfile.TemporaryDirectory(dir=ROOT / "build"))
            prof = stack.enter_context(trace(log_dir))
        else:
            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
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
    return len(kernels), busy_ms


def report_steps(label: str, run, card: str, stats: dict | None = None,
                 via_trace: bool = False):
    """The median step time (steps 2-16) and peak memory of a
    ``timed_train`` run, then one profiled step. ``stats``, where given,
    receives step_ms, peak_gib, kernels and busy_share."""
    import statistics

    tr, times, peak, args = run
    step_ms = statistics.median(times[1:])
    print(f"train step {label}: median of steps 2-{len(times)} {step_ms:.2f} ms "
          f"(step 1 {times[0]:.2f} ms), peak allocated {peak / 2**30:.3f} GiB; {card}",
          flush=True)
    kernels, busy_ms = None, None
    if DEVICE == "cuda":
        kernels, busy_ms = profile_step(tr, args, label, step_ms, card, via_trace=via_trace)
    if stats is not None:
        stats.update(step_ms=step_ms, peak_gib=peak / 2**30, kernels=kernels,
                     busy_share=None if busy_ms is None else busy_ms / step_ms)
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
    often, and no lane kernel runs. Losses must be finite, and both
    checkpoints must restore. Returns the ``timed_train`` run and the
    four launch counts."""
    import tempfile

    import numpy as np
    import torch

    from cbfssm_tpu_torch.training import Trainer, checkpoint

    batch = int(model.config.batch_size)
    steps = -(-ds.train_in_batch.shape[0] // batch)
    test_batches = -(-ds.test_in_batch.shape[0] // batch)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
        reset_launches()
        t0 = time.perf_counter()
        run = timed_train(model, model_dir, ds)
        epoch_s = time.perf_counter() - t0
        counts = read_launches(
            where, (test_batches * steps_per_batch, steps * steps_per_batch, 0, 0),
            f"({test_batches} test batches, {steps} steps) x {steps_per_batch}, no lanes")
        launches, residual_launches = counts[:2]
        trainer = run[0]
        if not (np.isfinite(trainer.train_all).all() and np.isfinite(trainer.test_all).all()):
            fail(f"{where}: non-finite losses: train {trainer.train_all}, "
                 f"test {trainer.test_all}")
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
    return run, counts


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


def adjoint_parity(make_model, params0, ds, where: str, adjoint: str, batch: int,
                   seq_len: int, tols: dict):
    """The loss and every gradient leaf of one fixed batch and draw under
    ``adjoint`` against autodiff, both ``gp_impl='solve_free'``, on the
    card: the loss bitwise, each leaf within ``|a - b| <= atol + rtol *
    |b|`` for each dtype's ``(rtol, atol)`` in ``tols`` (the JAX tests'
    tolerances)."""
    import torch

    for dtype, (rtol, atol) in tols.items():
        auto = make_model(dtype, "solve_free")
        other = make_model(dtype, "solve_free", adjoint=adjoint)
        kw = dict(dtype=auto.dtype, device=DEVICE)
        u = torch.as_tensor(ds.train_in_batch[:batch], **kw)
        y = torch.as_tensor(ds.train_out_batch[:batch], **kw)
        noise = auto.draw_noise(torch.Generator(DEVICE).manual_seed(7), seq_len, batch)
        l_a, g_a, _ = loss_and_grads(auto, params0.to(auto.dtype), u, y, noise)
        l_o, g_o, _ = loss_and_grads(other, params0.to(auto.dtype), u, y, noise)
        if float(l_a) != float(l_o):
            fail(f"{where}: {dtype} loss under adjoint={adjoint!r} {float(l_o)!r} != autodiff's "
                 f"{float(l_a)!r} (the same step bodies must give the same bits)")
        worst = 0.0
        for k, (a, b) in enumerate(zip(g_o, g_a)):
            err = (a - b).abs()
            ratio = float((err / (atol + rtol * b.abs())).max())
            if ratio > 1.0:
                fail(f"{where}: {dtype} gradient of leaf {k} under adjoint={adjoint!r}: max abs "
                     f"err {float(err.max()):.3e}, largest entry {float(b.abs().max()):.3e}, "
                     f"{ratio:.3g} x the tolerance (rtol {rtol:g}, atol {atol:g})")
            worst = max(worst, ratio)
        print(f"adjoint parity {where}: {dtype} adjoint={adjoint!r} vs autodiff: loss "
              f"{float(l_o)!r} equal bitwise; {len(g_o)} gradient leaves within rtol {rtol:g} / "
              f"atol {atol:g} (largest error {worst:.3g} x the tolerance)", flush=True)


def compare_schedules(where: str, stats: dict, card: str):
    """One line: step time, peak memory, kernels and busy share of each
    schedule in ``stats`` (measured in this run)."""
    parts = [f"{name} {st['step_ms']:.2f} ms, {st['peak_gib']:.3f} GiB, {st['kernels']} "
             f"kernels, busy {100 * st['busy_share']:.1f} %" if st.get("kernels") is not None
             else f"{name} {st['step_ms']:.2f} ms, {st['peak_gib']:.3f} GiB"
             for name, st in stats.items()]
    print(f"schedules {where}: " + "; ".join(parts) + f"; {card}", flush=True)


def hand_training(card: str, ds, make_model, plain, stats: dict):
    """The ``adjoint='hand'`` path: one float32 Trainer epoch (16 Adam
    steps, 3 test batches) of CBFSSM with ``gp_impl='solve_free'``,
    beside the solve_free autodiff epoch ``plain``: no kernel of the four
    launches; the first step's loss equals autodiff's bitwise (same init,
    shuffle and draws); gradient parity against autodiff (float64 rtol
    1e-7 / atol 1e-12, float32 rtol 2e-3 / atol 1e-5); step time, peak
    memory and one step under ``utils.profiling.trace``. Returns the four
    launch counts."""
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
        reset_launches()
        run = timed_train(make_model("float32", "solve_free", adjoint="hand"), model_dir, ds)
        counts = read_launches("CBFSSM adjoint=hand", (0, 0, 0, 0),
                               "gp_impl='solve_free' launches none of the four kernels")
    trainer = run[0]
    if not (np.isfinite(trainer.train_all).all() and np.isfinite(trainer.test_all).all()):
        fail(f"CBFSSM adjoint=hand: non-finite losses: train {trainer.train_all}, test "
             f"{trainer.test_all}")
    first, want = trainer.step_losses[0], plain[0].step_losses[0]
    if first != want:
        fail(f"CBFSSM adjoint=hand: first step's loss {first!r} != autodiff's {want!r}")
    print(f"training CBFSSM adjoint=hand: 1 epoch of {len(run[1])} Adam steps in "
          f"{sum(run[1]) / 1e3:.2f} s of steps; train loss {trainer.train_all[0]!r} (autodiff "
          f"{plain[0].train_all[0]!r}), test loss {trainer.test_all[0]!r}; first step's loss "
          f"{first!r} equal to autodiff's bitwise; launches {counts}", flush=True)
    adjoint_parity(make_model, trainer.params.detach(), ds, "CBFSSM", "hand", BATCH, SEQ_LEN,
                   {"float64": (1e-7, 1e-12), "float32": (2e-3, 1e-5)})
    report_steps(f"CBFSSM gp_impl=solve_free adjoint=hand B={BATCH} float32", run, card,
                 stats=stats.setdefault("solve_free-hand", {}), via_trace=True)
    compare_schedules(f"CBFSSM B={BATCH} float32", stats, card)
    print(f"phase 5 adjoint=hand: {time.perf_counter() - t0:.2f} s", flush=True)
    return counts


def trainer_profile_dir(card: str):
    """``Trainer(profile_dir=)`` on a cut run: CBFSSM at the RoboMove
    width, float32, 'pallas', windows of ``PROFILE_SEQ`` steps (a
    sequential recognition), 2 epochs of 2 Adam steps and 1 test batch.
    Epoch 1's training is traced: one ``*.pt.trace.json`` that holds
    CUDA kernel events, ``gp_predict_residuals`` 2 x 119 of them; the
    losses equal those of the same run without ``profile_dir``. Returns
    the four launch counts."""
    import glob
    import os
    import tempfile

    from cbfssm_tpu_torch.data import RoboMove
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.training import Trainer

    t0 = time.perf_counter()
    ds = RoboMove(PROFILE_SEQ, SEQ_STRIDE)
    ds.train_in_batch, ds.train_out_batch = (a[:2 * BATCH] for a in (ds.train_in_batch,
                                                                     ds.train_out_batch))
    ds.test_in_batch, ds.test_out_batch = (a[:BATCH] for a in (ds.test_in_batch,
                                                               ds.test_out_batch))
    model = CBFSSM(config("float32", "pallas"), device=DEVICE)
    if model.backward_schedule(PROFILE_SEQ) != "sequential":
        fail(f"trainer_profile: {PROFILE_SEQ} steps do not take the sequential recognition")
    per_step = 2 * PROFILE_SEQ - 1  # T recognition + T - 1 forward predicts
    losses = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        log_dir = os.path.join(root, "trace")
        reset_launches()
        traced = Trainer(model, os.path.join(root, "a"), seed=0, profile_dir=log_dir)
        traced.train(ds, epochs=2)
        counts = read_launches("trainer_profile", (2 * per_step, 4 * per_step, 0, 0),
                               f"2 epochs x (2 steps, 1 test batch) x {per_step}")
        losses["traced"] = (traced.train_all, traced.test_all)
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        if len(files) != 1:
            fail(f"trainer_profile: {len(files)} trace files in profile_dir, want 1")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        plain = Trainer(model, os.path.join(root, "b"), seed=0)
        plain.train(ds, epochs=2)
        losses["plain"] = (plain.train_all, plain.test_all)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    gp = [e for e in kernels if "gp_predict" in e.get("name", "")]
    if len(gp) != 2 * per_step:
        names = sorted({e.get("name", "")[:80] for e in kernels})[:20]
        fail(f"trainer_profile: the trace holds {len(gp)} gp_predict kernel events of "
             f"{len(kernels)} kernels, want 2 x {per_step}; kernel names: {names}")
    if losses["traced"] != losses["plain"]:
        fail(f"trainer_profile: losses with profile_dir {losses['traced']} != without "
             f"{losses['plain']}")
    print(f"trainer_profile: Trainer(profile_dir=) 2 epochs of 2 steps (seq {PROFILE_SEQ}): one "
          f"trace file of {size / 2**20:.1f} MiB, {len(events)} events, {len(kernels)} CUDA "
          f"kernel events ({len(gp)} gp_predict_residuals = 2 x {per_step}); losses equal "
          f"without it; launches {counts}; {time.perf_counter() - t0:.2f} s", flush=True)
    return counts


def phase_training(card: str):
    """One full-width RoboMove epoch of CBFSSM through Trainer (the main
    path), then gradient parity and step times of both gp_impl values,
    the hand adjoint's epoch beside solve_free autodiff, and
    ``Trainer(profile_dir=)``. Returns the main path's counts and those
    of the two new paths."""
    import tempfile

    from cbfssm_tpu_torch.models import CBFSSM

    def make_model(dtype, impl, **overrides):
        return CBFSSM(config(dtype, impl, **overrides), device=DEVICE)

    ds = robomove()
    run, counts = train_main_path(make_model("float32", "pallas"), ds, STEPS_PER_CHUNK,
                                  "CBFSSM")
    gradient_parity(make_model, run[0].params.detach(), ds, "CBFSSM")
    # step time and peak memory, float32, B = 32: the main-path epoch
    # above and one more of gp_impl='solve_free', each with kernels
    # counted under utils.profiling.trace
    stats = {}
    report_steps(f"CBFSSM gp_impl=pallas B={BATCH} float32", run, card,
                 stats=stats.setdefault("pallas-autodiff", {}), via_trace=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
        plain = timed_train(make_model("float32", "solve_free"), model_dir, ds)
    report_steps(f"CBFSSM gp_impl=solve_free B={BATCH} float32", plain, card,
                 stats=stats.setdefault("solve_free-autodiff", {}), via_trace=True)
    hand = hand_training(card, ds, make_model, plain, stats)
    adam_update_cost(run[0], card)
    return counts, {"training_hand": hand, "trainer_profile": trainer_profile_dir(card)}


def adam_update_cost(trainer, card: str, steps: int = 20) -> None:
    """The Trainer's Adam update (``Trainer._adam_update``: ``adam_leaf``
    a leaf, the step count on the device) against ``torch.optim.Adam``'s
    own step (foreach, the count on the host) on copies of the trained
    CBFSSM leaves with the same seeded gradients: host ms an update
    (``steps`` updates, then one sync), device kernels of one update
    under ``torch.profiler`` (which, after the script's earlier profiler
    sessions, has seen none of a foreach launch's kernels), and the
    largest difference of the leaves after the updates over each leaf's
    largest entry (at most 1e-5)."""
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cbfssm_tpu_torch.training import Trainer

    lr = float(trainer.model.config.learning_rate)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    base = [t.detach().clone() for t in trainer.params.tensors()]
    grads = [[torch.randn(t.shape, generator=gen, dtype=t.dtype, device=DEVICE) for t in base]
             for _ in range(steps + 4)]
    leaves = {}
    for name in ("port", "torch.optim.Adam"):
        leaves[name] = [t.clone().requires_grad_(True) for t in base]
    port = types.SimpleNamespace(optimizer=torch.optim.Adam(leaves["port"], lr=lr))
    ref = torch.optim.Adam(leaves["torch.optim.Adam"], lr=lr)
    updates = {"port": lambda: Trainer._adam_update(port, leaves["port"]),
               "torch.optim.Adam": ref.step}
    out = {}
    for name, update in updates.items():
        def step(i, name=name, update=update):
            for p, g in zip(leaves[name], grads[i]):
                p.grad = g
            update()

        for i in range(3):  # first calls: state and foreach set-up
            step(i)
        sync()
        t0 = time.perf_counter()
        for i in range(3, 3 + steps):
            step(i)
        sync()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(3 + steps)
            sync()
        kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
        out[name] = (ms, kernels)
    diff = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(*(map(torch.Tensor.detach, leaves[k]) for k in updates)))
    if not diff < 1e-5:
        fail(f"adam update: the port's update left the leaves {diff:.3e} of their largest "
             f"entry from torch.optim.Adam's after {steps + 4} updates")
    print(f"adam update CBFSSM {trainer.model.dtype} ({len(base)} leaves): port {out['port'][0]:.3f} ms, "
          f"{out['port'][1]} kernels, torch.optim.Adam (foreach) "
          f"{out['torch.optim.Adam'][0]:.3f} ms, {out['torch.optim.Adam'][1]} kernels "
          f"(host ms an update, mean of {steps}; kernels as torch.profiler saw them, which "
          f"after this script's earlier sessions misses foreach launches); leaves after "
          f"{steps + 4} updates within "
          f"{diff:.3e} of the largest entry; {card}", flush=True)


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
    counts by path and the trained CBFSSMHALF params (phase 10 serves
    them)."""
    import torch

    from cbfssm_tpu_torch.models import CBFSSMHALF, PRSSM

    ds = robomove()
    u_all, y_all = served_windows()
    by_path, half_params = {}, None
    for name, cls in (("cbfssmhalf", CBFSSMHALF), ("prssm", PRSSM)):
        def make_model(dtype, impl, cls=cls):
            return rnn_model(cls, dtype, impl)

        where = cls.__name__
        model = make_model("float32", "pallas")
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
        serve = serve_main_path(model, params, u_all, y_all, FORWARD_STEPS, where)
        run, counts = train_main_path(model, ds, FORWARD_STEPS, where)
        trained = run[0].params.detach()
        gradient_parity(make_model, trained, ds, where)
        predict_parity(make_model, trained, u_all[:8], y_all[:8], where)
        report_steps(f"{where} gp_impl=pallas B={BATCH} float32", run, card)
        request_latency(make_model, trained, u_all, y_all, ("pallas",), card, where)
        by_path[f"serving_{name}"] = serve
        by_path[f"training_{name}"] = counts
        if cls is CBFSSMHALF:
            half_params = trained
    recognition_parity(half_params)
    return by_path, half_params


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
    one profiled step. Returns the four launch counts."""
    import importlib.util
    import os
    import tempfile

    import numpy as np
    import scipy.io
    import torch

    from cbfssm_tpu_torch import run_voliro
    from cbfssm_tpu_torch.models import Voliro
    from cbfssm_tpu_torch.outputs import Outputs, OutputsVoliro

    def make_model(dtype, impl, **overrides):
        return Voliro(dict(run_voliro.model_config, dtype=dtype, gp_impl=impl, **overrides),
                      device=DEVICE)

    seq_len, batch = run_voliro.seq_len, run_voliro.model_config["batch_size"]
    # without matplotlib (the card's machine may lack it) the two plots
    # are skipped here, and only here; voliro_forces.mat is checked
    plots = importlib.util.find_spec("matplotlib") is not None
    saved = Outputs.training_stats, OutputsVoliro._plot_forces
    if not plots:
        Outputs.training_stats = OutputsVoliro._plot_forces = lambda self, *a: None
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
            reset_launches()
            t0 = time.perf_counter()
            outputs = run_voliro.main(
                root=root, epochs=1, data_dir=data_dir,
                config_overrides={"gp_impl": "pallas", "dtype": "float32"}, device=DEVICE)
            counts = launch_counts()
            run_s = time.perf_counter() - t0
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
    if counts != (want_value, steps * (1 + seq_len), 0, 0):
        fail(f"Voliro: {COUNTERS} launches {counts} != ({want_value}, {steps * (1 + seq_len)}, "
             f"0, 0): {test_batches} test batches x {1 + seq_len} + OutputsVoliro predicts over "
             f"logs of {logs} steps (1 + T each), {steps} steps x {1 + seq_len}")
    launches, residual_launches = counts[:2]
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
    return counts, voliro_parallel(card, make_model, params, ds, batch, seq_len)


def voliro_parallel(card: str, make_model, params, ds, batch: int, seq_len: int):
    """The ``adjoint='parallel'`` path of Voliro (``gp_impl='solve_free'``):
    gradient parity against autodiff in float64 (loss bitwise, leaves at
    rtol 1e-7 / atol 1e-11), then 10 float32 Adam steps on one batch of
    each schedule from the trained params: step time, peak memory,
    kernels per step. The parallel steps launch none of the four kernels.
    Returns their launch counts."""
    import tempfile

    import torch

    from cbfssm_tpu_torch.training import Trainer

    t0 = time.perf_counter()
    adjoint_parity(make_model, params, ds, "Voliro", "parallel", batch, seq_len,
                   {"float64": (1e-7, 1e-11)})
    kw = dict(dtype=torch.float32, device=DEVICE)
    stats, counts = {}, None
    for adjoint in ("autodiff", "parallel"):
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
            trainer = Trainer(make_model("float32", "solve_free", adjoint=adjoint), model_dir,
                              init_params=params)
        trainer.init_state()
        args = (torch.as_tensor(ds.train_in_batch[:batch], **kw),
                torch.as_tensor(ds.train_out_batch[:batch], **kw), torch.ones(batch, **kw),
                torch.Generator(device=DEVICE).manual_seed(5))
        if adjoint == "parallel":
            reset_launches()
        run = timed_steps(trainer, args, 10)
        if adjoint == "parallel":
            counts = read_launches("Voliro adjoint=parallel", (0, 0, 0, 0),
                                   "gp_impl='solve_free' launches none of the four kernels")
        report_steps(f"Voliro gp_impl=solve_free adjoint={adjoint} B={batch} float32 (10 steps "
                     "on one batch)", run, card, stats=stats.setdefault(f"solve_free-{adjoint}",
                                                                      {}))
    compare_schedules(f"Voliro B={batch} float32", stats, card)
    print(f"phase 7 adjoint=parallel: {time.perf_counter() - t0:.2f} s", flush=True)
    return counts


def phase_sarcos(card: str, data_dir: str):
    """The Sarcos training path: CBFSSM at the full width of
    run_sarcos.py (dim_x 14, M 100, S 20, B 5, seq 250 / stride 10,
    recog_len 16), float32, 'pallas', through ``Trainer`` for one epoch
    cut to 8 Adam steps (the first 40 of the 600 training windows of a
    synthetic sarcos_inv.mat; all 60 test windows). Each step launches
    ``gp_predict_residuals`` 281 times (2 x 16 blocked recognition steps
    + 249 forward steps), each test batch ``gp_predict`` as often. Then
    the parity of the two gp_impl paths, step time, peak memory and one
    profiled step. Returns the four launch counts."""
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
    run, counts = train_main_path(make_model("float32", "pallas"), ds, per_batch, "Sarcos")
    params = run[0].params.detach()
    gradient_parity(make_model, params, ds, "Sarcos", batch=batch, seq_len=seq_len,
                    f32_vs_f64=True)
    predict_parity(make_model, params, ds.test_in_batch[:8], ds.test_out_batch[:8], "Sarcos",
                   seq_len=seq_len)
    STEP_MS["sarcos"] = report_steps(f"Sarcos gp_impl=pallas B={batch} float32", run, card)
    return counts


def phase_voliro_sarcos(card: str):
    """Phase 7: the kernels at the new shapes, then Voliro and Sarcos on
    synthetic data files written from seed 0."""
    import tempfile

    from cbfssm_tpu_torch.data import synthetic

    model_kernels = phase_model_kernels()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as data_dir:
        synthetic.stage_all(data_dir, seed=0)
        voliro, parallel = phase_voliro(card, data_dir)
        paths = {"voliro": voliro, "voliro_parallel": parallel,
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
    to 8 steps as phase 7 cuts it, then each seed's Outputs into
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
    from cbfssm_tpu_torch.outputs import Outputs
    from cbfssm_tpu_torch.outputs.summary import vmapped_reproduction
    from cbfssm_tpu_torch.training import MultiSeedTrainer

    def make_model(dtype, impl):
        return CBFSSM(dict(run_sarcos.model_config, dtype=dtype, gp_impl=impl), device=DEVICE)

    seq_len, batch = run_sarcos.seq_len, run_sarcos.model_config["batch_size"]
    per_batch = 2 * run_sarcos.model_config["recog_len"] + seq_len - 1
    ds = Sarcos(seq_len, run_sarcos.seq_stride, data_dir=data_dir)
    ds.train_in_batch = ds.train_in_batch[:SARCOS_STEPS * batch]
    ds.train_out_batch = ds.train_out_batch[:SARCOS_STEPS * batch]
    test_batches = -(-ds.test_in_batch.shape[0] // batch)
    steps, evals, box = [], [], {}
    step_fn, eval_fn = MultiSeedTrainer.train_step, MultiSeedTrainer._epoch_eval

    def timed_step(self, *args):
        before = launch_counts()
        t0 = time.perf_counter()
        out = step_fn(self, *args)
        sync()
        steps.append((1e3 * (time.perf_counter() - t0),
                      tuple(a - b for a, b in zip(launch_counts(), before))))
        box["trainer"], box["args"] = self, args
        return out

    def counted_eval(self, *args):
        before = launch_counts()
        out = eval_fn(self, *args)
        evals.append(tuple(a - b for a, b in zip(launch_counts(), before)))
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
            reset_launches()
            t0 = time.perf_counter()
            summary = vmapped_reproduction(make_model("float32", "pallas"), ds, root,
                                           SARCOS_SEEDS, 1)
            launches = launch_counts()
            run_s = time.perf_counter() - t0
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
        reset_launches()
        t0 = time.perf_counter()
        sweep.train(ds, epochs=1)
        launches = launch_counts()
        run_s = time.perf_counter() - t0
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

    def make_cbfssm(dtype, impl, **overrides):
        return CBFSSM(config(dtype, impl, **overrides), device=DEVICE)

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
    hand = lanes_hand(card, ds, make_cbfssm)
    return lane_kernels, {"lanes": lanes, "sweep": sweep, "lanes_hand": hand}


def lanes_hand(card: str, ds, make_model):
    """(g) One lane-batched gradient step (``MultiSeedTrainer.lane_losses``
    and backward) of the RoboMove CBFSSM with ``adjoint='hand'`` against
    autodiff, both ``gp_impl='solve_free'``, at ``HAND_LANES`` lanes of
    ``HAND_LANE_BATCH`` windows each (cut from the sweep's 4 lanes at
    B 32 to stay in the time budget): in float64 each lane's loss
    bitwise and every gradient leaf at rtol 1e-7 / atol 1e-12; in
    float32 the median of 3 steps of each. The hand steps launch none of
    the four kernels. Returns their launch counts."""
    import statistics
    import tempfile

    import torch

    from cbfssm_tpu_torch.training import MultiSeedTrainer

    t0 = time.perf_counter()
    lanes, batch = HAND_LANES, HAND_LANE_BATCH
    params = stacked_init(make_model("float64", "solve_free"), lanes)
    result, counts = {}, None
    for dtype in ("float64", "float32"):
        kw = dict(dtype=getattr(torch, dtype), device=DEVICE)
        u = torch.as_tensor(ds.train_in_batch[:lanes * batch], **kw).reshape(
            (lanes, batch) + ds.train_in_batch.shape[1:])
        y = torch.as_tensor(ds.train_out_batch[:lanes * batch], **kw).reshape(
            (lanes, batch) + ds.train_out_batch.shape[1:])
        w = torch.ones((lanes, batch), **kw)
        for adjoint in ("autodiff", "hand"):
            model = make_model(dtype, "solve_free", adjoint=adjoint)
            noises = [model.draw_noise(torch.Generator(DEVICE).manual_seed(60 + lane), SEQ_LEN,
                                       batch) for lane in range(lanes)]
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as model_dir:
                ms = MultiSeedTrainer(model, model_dir, n_seeds=lanes)
            times = []
            if dtype == "float32" and adjoint == "hand":
                reset_launches()
            for _ in range(1 if dtype == "float64" else 3):
                leaves = [t.detach().to(kw["dtype"]).clone().requires_grad_(True)
                          for t in params.tensors()]
                t_step = time.perf_counter()
                losses = ms.lane_losses(params.with_tensors(leaves), u, y, w, noises)
                grads = torch.autograd.grad(losses.sum(), leaves)
                sync()
                times.append(1e3 * (time.perf_counter() - t_step))
            if dtype == "float32" and adjoint == "hand":
                counts = read_launches("lanes adjoint=hand", (0, 0, 0, 0),
                                       "gp_impl='solve_free' launches none of the four kernels")
            result[(dtype, adjoint)] = (losses.detach(), grads, statistics.median(times))
    (l_a, g_a, _), (l_h, g_h, _) = result[("float64", "autodiff")], result[("float64", "hand")]
    if not torch.equal(l_a, l_h):
        fail(f"lanes adjoint=hand: float64 lane losses {l_h.tolist()} != autodiff's "
             f"{l_a.tolist()}")
    worst = 0.0
    for k, (a, b) in enumerate(zip(g_h, g_a)):
        ratio = float(((a - b).abs() / (1e-12 + 1e-7 * b.abs())).max())
        if ratio > 1.0:
            fail(f"lanes adjoint=hand: float64 gradient of leaf {k}: {ratio:.3g} x the "
                 "tolerance (rtol 1e-7, atol 1e-12)")
        worst = max(worst, ratio)
    ms_a, ms_h = result[("float32", "autodiff")][2], result[("float32", "hand")][2]
    print(f"lanes adjoint=hand: {lanes} lanes x B {batch} (RoboMove CBFSSM, solve_free): "
          f"float64 lane losses equal autodiff's bitwise, {len(g_h)} gradient leaves within "
          f"rtol 1e-7 / atol 1e-12 (largest error {worst:.3g} x the tolerance); float32 lane "
          f"step (loss + backward, median of 3) hand {ms_h:.2f} ms, autodiff {ms_a:.2f} ms; "
          f"launches {counts}; {card}; {time.perf_counter() - t0:.2f} s", flush=True)
    return counts


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


def serve_subprocess(args: list, log_dir: str, where: str, use):
    """``python -m cbfssm_tpu_torch <args> --port 0`` in its own process
    through ``__main__.main`` (the SIGTERM handler needs the main
    thread): waits for the banner with the address, calls
    ``use(base_url)``, then SIGTERM must end the process with exit 0
    after 'shutting down'. Returns (banner, seconds to the banner,
    ``use``'s result, the four launch counts the process printed)."""
    import os
    import queue
    import signal

    prog = ("import sys\n"
            "from cbfssm_tpu_torch.__main__ import main\n"
            "from cbfssm_tpu_torch.ops import fused_predict as fp\n"
            "rc = main(sys.argv[1:])\n"
            "print('launches', fp.fused_predict.launches, fp.fused_predict_residuals.launches,"
            " fp.fused_predict.lane_launches, fp.fused_predict_residuals.lane_launches,"
            " flush=True)\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    err_log = open(os.path.join(log_dir, "serve_stderr.txt"), "w+")
    dev = [] if DEVICE == "cuda" else ["--device", DEVICE]  # a CPU rehearsal passes its device
    proc = subprocess.Popen([sys.executable, "-c", prog, *args, "--port", "0", *dev],
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
            fail(f"{where}: no banner ({banner!r}); stderr: {stderr_tail()}")
        ready_s = time.perf_counter() - t0
        result = use(banner.strip().rsplit(" ", 1)[1])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        rest = []
        while (line := lines.get(timeout=30)) is not None:
            rest.append(line)
        if rc != 0 or not any("shutting down" in ln for ln in rest):
            fail(f"{where}: exit {rc} after SIGTERM; stdout {rest}; stderr {stderr_tail()}")
        counts = next(ln for ln in rest if ln.startswith("launches")).split()[1:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        err_log.close()
    return banner.strip(), ready_s, result, tuple(int(c) for c in counts)


def cli_serve_subprocess(model_dir: str, u, y, direct, card: str) -> int:
    """(e) ``serve <dir> --port 0`` in its own process
    (:func:`serve_subprocess`): one JSON request, held against the
    direct call of dispatch 0 at float32 tolerance (another process).
    Returns the four launch counts it printed."""
    import numpy as np

    def use(base):
        t1 = time.perf_counter()
        code, reply = http_json("POST", base + "/v1/predict", {"u": u.tolist(), "y": y.tolist()})
        first_ms = 1e3 * (time.perf_counter() - t1)
        if code != 200:
            fail(f"CLI serve: predict answered {code}: {reply}")
        err = max(float(np.abs(np.asarray(reply[f]) - getattr(direct, f)[0]).max())
                  for f in ("pred_mean", "pred_var"))
        if not np.allclose(reply["pred_mean"], direct.pred_mean[0], rtol=1e-5, atol=1e-6):
            fail(f"CLI serve: reply differs from the direct call by {err:.3e}")
        return first_ms, err

    banner, ready_s, (first_ms, err), counts = serve_subprocess(
        ["serve", model_dir], model_dir, "CLI serve", use)
    print(f"CLI serve: {banner}; ready in {ready_s:.2f} s, first request "
          f"{first_ms:.2f} ms (max abs diff to the direct call {err:.3e}); SIGTERM: exit 0, "
          f"'shutting down'; {COUNTERS} launches {counts}; {card}", flush=True)
    if counts != (STEPS_PER_CHUNK, 0, 0, 0):
        fail(f"CLI serve: {COUNTERS} launches {counts} != ({STEPS_PER_CHUNK}, 0, 0, 0) (one "
             "dispatch)")
    return counts


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

        reset_launches()
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
    counts = read_launches("HTTP serve", STEPS_PER_CHUNK * len(dispatched),
                           f"{STEPS_PER_CHUNK} x {len(dispatched)} dispatches")
    launches = counts[0]
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
    return counts, model, params


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
            reset_launches()
            t0 = time.perf_counter()
            if cli.main(["reproduce", "robomove", "--epochs", "1", "--root", root, *dev]) != 0:
                fail("CLI reproduce robomove did not return 0")
            sync()
            run_s = time.perf_counter() - t0
            paths["cli_reproduce"] = read_launches(
                "CLI reproduce", (2 * (test_batches * STEPS_PER_CHUNK + per_outputs),
                                  2 * steps * STEPS_PER_CHUNK, 0, 0),
                f"2 phases x ({test_batches} test batches x {STEPS_PER_CHUNK} + OutputsRoboMove "
                f"{per_outputs}), 2 x {steps} steps x {STEPS_PER_CHUNK}")
            for name in ("best.ckpt", "model.ckpt", "model_meta.json", "mse.txt",
                         "calibration.txt", "predict_test.mat"):
                if not os.path.isfile(os.path.join(root, name)):
                    fail(f"CLI reproduce: {name} was not written")
            print(f"CLI reproduce robomove: 2 curriculum phases of 1 epoch ({steps} Adam steps, "
                  f"{test_batches} test batches) and their OutputsRoboMove in {run_s:.2f} s; "
                  f"{COUNTERS} launches {paths['cli_reproduce']} = "
                  f"2 x ({test_batches} x {STEPS_PER_CHUNK} + {per_outputs}), 2 x {steps} x "
                  f"{STEPS_PER_CHUNK}, 0, 0" + ("" if plots else
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

            reset_launches()
            t0 = time.perf_counter()
            if cli.main(["eval", root, "--out", evaldir, *dev]) != 0:
                fail("CLI eval did not return 0")
            sync()
            eval_s = time.perf_counter() - t0
            paths["cli_eval"] = read_launches("CLI eval", per_outputs, "OutputsRoboMove")
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
            paths["http_serve"], model, params = http_serve(root, u_all, y_all, card)
            direct = BucketedPredictor(model, params, SEQ_LEN, buckets=BUCKETS)(
                u_all[:1], y_all[:1], fold_seed(0, 0))
            paths["cli_serve"] = cli_serve_subprocess(root, u_all[0], y_all[0], direct, card)
    finally:
        outputs_mod.pyplot, outputs_robomove.pyplot = saved
    return paths


def rnn_model(cls, dtype: str, impl: str):
    """Phase 6's models: the RoboMove phase-0 width with the GRU
    recognition net and var_y of length dim_y = 2."""
    import numpy as np

    return cls(config(dtype, impl, var_y=np.asarray([1.0**2] * 2), recog_model="rnn"),
               device=DEVICE)


def host(a):
    """A tensor or array as a host numpy array."""
    import numpy as np

    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def timed_call(times: list, fn, *args):
    """``fn(*args)``; its host ms, ending in a device sync, appended to
    ``times``."""
    t0 = time.perf_counter()
    out = fn(*args)
    sync()
    times.append(1e3 * (time.perf_counter() - t0))
    return out


def fmt_times(times: list) -> str:
    import statistics

    return (f"median {statistics.median(times):.3f} of {len(times)} (min {min(times):.3f}, "
            f"max {max(times):.3f})")


def check_moments(where: str, mean, var, shape):
    """Shape, finiteness and positive variance of filtered moments."""
    import numpy as np

    mean, var = host(mean), host(var)
    if mean.shape != shape or var.shape != shape:
        fail(f"{where}: moments of shape {mean.shape} / {var.shape}, want {shape}")
    if not (np.isfinite(mean).all() and np.isfinite(var).all() and (var > 0).all()):
        fail(f"{where}: non-finite moments or non-positive variance")


def same_pair(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(host(x), host(y)) for x, y in zip(a, b))


def phase_filter_kernels():
    """``gp_predict`` against its plain version at the online-filter
    shapes (``kernel_timing.FILTER_SHAPES``: a 1,024-session fleet at
    N = 51,200, 32 sessions, one stream, a Voliro pool of 8) in float32
    (rtol 2e-5, atol 1e-5) and float64 (rtol 1e-10, atol 1e-12), each
    timed by graph replay beside its bound and 50 eager calls of the
    plain version. Returns {path: figures}."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.utils.kernel_timing import FILTER_SHAPES, graph_replay_ms, kernel_inputs

    tol = {torch.float32: (2e-5, 1e-5), torch.float64: (1e-10, 1e-12)}
    out = {}
    rng = np.random.default_rng(3)
    for path, (n, m, di, d) in FILTER_SHAPES.items():
        for dtype, (rtol, atol) in tol.items():
            args = kernel_inputs(rng, n, m, di, d, dtype, DEVICE)
            got = fp._fused_predict_value(*args)
            sync()
            want = fp.fused_predict_plain(*args)
            err = 0.0
            for g, w in zip(got, want):
                e = (g - w).abs()
                if bool((e > atol + rtol * w.abs()).any()):
                    fail(f"gp_predict {path} {dtype}: max abs err {float(e.max()):.3e} outside "
                         f"rtol {rtol} atol {atol}")
                err = max(err, float(e.max()))
            dev_ms = graph_replay_ms(lambda: fp._fused_predict_value(*args))
            plain_ms = cuda_ms(lambda: fp.fused_predict_plain(*args), 50)
            dt = str(dtype)[6:]
            bound_ms, bound_by = bound(n, m, di, d, dt, False)
            fig = out.setdefault(path, {"shape": f"N={n} M={m} DI={di} D={d}"})
            if dtype == torch.float32:
                fig.update(ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           max_abs_err=err)
            else:
                fig.update(ms_f64=dev_ms, plain_ms_f64=plain_ms, bound_ms_f64=bound_ms)
            print(f"gp_predict {dt} filter {path} N={n} M={m} DI={di} D={d}: ok (max abs err "
                  f"{err:.3e}); device {dev_ms:.5f} ms (graph replay), bound {bound_ms:.5f} ms "
                  f"({bound_by}; {100 * bound_ms / dev_ms:.1f} % of bound), plain "
                  f"{plain_ms:.4f} ms", flush=True)
    return out


def filter_stream(model, params, u_all, y_all, card: str) -> tuple:
    """(a) One stream: ``StreamingFilter(batch=1, replay_buckets=(16,
    64))``: start, 64 updates, a 50-step forecast; then its post-start
    state restored into a filter of another seed, which replays the 64
    steps in one chunk, equal to the updates bitwise (float32), and at
    rtol 1e-12 in a float64 repeat. Returns the four launch counts:
    ``gp_predict`` 1 per update, H per forecast, 64 for the chunk
    (``filter_init`` runs the GRU: 0)."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.serving import StreamingFilter

    r = int(model.config.recog_len)
    u, y = u_all[:1], y_all[:1]
    k_n = FILTER_TICKS

    def run(m, p, times):
        f = StreamingFilter(m, p, batch=1, replay_buckets=REPLAY_BUCKETS)
        timed_call(times["start"], f.start, u[:, :r], y[:, :r])
        snap = f.state
        seq = [timed_call(times["update"], f.update, u[:, r - 1 + k], y[:, r + k])
               for k in range(k_n)]
        fc = timed_call(times["forecast"], f.forecast, u[:, r - 1 + k_n:r - 1 + k_n + FORECAST_H])
        t0 = time.perf_counter()
        g = StreamingFilter(m, p, batch=1, seed=1, replay_buckets=REPLAY_BUCKETS)
        g.load_state(snap)
        times["state round trip"].append(1e3 * (time.perf_counter() - t0))
        rep = timed_call(times["replay"], g.replay, u[:, r - 1:r - 1 + k_n], y[:, r:r + k_n])
        seq_mv = tuple(np.stack([host(s[i]) for s in seq], axis=1) for i in (0, 1))
        return seq, fc, rep, seq_mv, f, g

    times = {k: [] for k in ("start", "update", "forecast", "state round trip", "replay")}
    reset_launches()
    t0 = time.perf_counter()
    seq, fc, rep, seq_mv, f, g = run(model, params, times)
    run_s = time.perf_counter() - t0
    counts = read_launches("filter_stream", k_n + FORECAST_H + REPLAY_BUCKETS[1],
                           f"{k_n} updates + forecast H {FORECAST_H} + one replay chunk of "
                           f"{REPLAY_BUCKETS[1]}")
    for k, (mean, var) in enumerate(seq):
        check_moments(f"filter_stream update {k}", mean, var, (1, 2))
    check_moments("filter_stream forecast", *fc, (1, FORECAST_H, 2))
    if not same_pair(rep, seq_mv):
        fail(f"filter_stream: the {k_n}-step replay differs from the updates by "
             f"{np.abs(rep[0] - seq_mv[0]).max():.3e} (float32, want bitwise)")
    if not np.array_equal(g.state[0], f.state[0]) or not g.state[1] == f.state[1] == k_n:
        fail("filter_stream: the replayed ensemble or counter differs from the updated one")
    # the float64 repeat, after the counted run
    m64 = rnn_model(type(model), "float64", "pallas")
    _, _, rep64, seq64, f64, g64 = run(m64, params.to(torch.float64),
                                       {k: [] for k in times})
    for a, b in (*zip(rep64, seq64), (g64.state[0], f64.state[0])):
        if not np.allclose(a, b, rtol=1e-12, atol=1e-14):
            fail(f"filter_stream float64: replay vs updates differ by {np.abs(a - b).max():.3e}")
    print(f"filter_stream: start, {k_n} updates, forecast H {FORECAST_H}, the start state "
          f"restored into a seed-1 filter, a {k_n}-step replay, in {run_s:.2f} s; replay equal "
          f"to the updates bitwise (float32) and at rtol 1e-12 (float64); gp_predict launches "
          f"{counts[0]} = {k_n} + {FORECAST_H} + {REPLAY_BUCKETS[1]}", flush=True)
    print(f"latency filter_stream (B=1, float32, host ms): update {fmt_times(times['update'])}; "
          f"start {times['start'][0]:.3f}; forecast H {FORECAST_H} {times['forecast'][0]:.3f}; "
          f"{k_n}-step replay {times['replay'][0]:.3f}; state round trip "
          f"{times['state round trip'][0]:.3f}; {card}", flush=True)
    return counts


def filter_fleet(model, params, u_all, y_all, card: str):
    """(b) A 32-session fleet (N = 1,600 rows a tick):
    ``FilterPool(capacity=32, replay_buckets=(16, 64))`` attaches 32
    test windows and runs 20 lockstep ticks, a hold tick (odd sessions
    only), a ragged replay (lengths uniform in [1, 64], seed 0), a
    50-step forecast, and a ``state`` restored into a pool of another
    seed, after which 3 ticks of both are equal. After the counted run:
    the 20 ticks equal a ``StreamingFilter(batch=32)`` from the same
    ensemble, the held rows did not move, the replay equals the
    tick-by-tick schedule (bitwise), and the kernel path equals
    ``gp_impl='solve_free'`` in float64 at rtol 1e-8. Returns the four
    launch counts and the fleet's state."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.serving import FilterPool, StreamingFilter, plan_replay_chunks

    r = int(model.config.recog_len)
    n = FLEET
    lengths = np.random.default_rng(0).integers(1, FILTER_TICKS + 1, size=n)
    t_rep = r + FLEET_TICKS + 1  # the backlog's first step

    def tick_inputs(sids, k, only=None):
        return {s: (u_all[i, r - 1 + k], y_all[i, r + k]) for i, s in enumerate(sids)
                if only is None or i % 2 == only}

    times = {k: [] for k in ("attach", "tick", "hold tick", "replay", "forecast", "state")}
    reset_launches()
    t0 = time.perf_counter()
    pool = FilterPool(model, params, capacity=n, replay_buckets=REPLAY_BUCKETS)
    sids = [timed_call(times["attach"], pool.attach, u_all[i, :r], y_all[i, :r])
            for i in range(n)]
    x0 = pool.state
    ticks = [timed_call(times["tick"], pool.step, tick_inputs(sids, k))
             for k in range(FLEET_TICKS)]
    after_lockstep = pool.state
    held = timed_call(times["hold tick"], pool.step, tick_inputs(sids, FLEET_TICKS, only=1))
    after_hold = pool.state
    backlog = {s: (u_all[i, t_rep - 1:t_rep - 1 + lengths[i]],
                   y_all[i, t_rep:t_rep + lengths[i]]) for i, s in enumerate(sids)}
    replayed = timed_call(times["replay"], pool.replay, backlog)
    after_replay = pool.state
    t_fc = t_rep + FILTER_TICKS
    fc = timed_call(times["forecast"], pool.forecast,
                    {s: u_all[i, t_fc:t_fc + FORECAST_H] for i, s in enumerate(sids)})
    t1 = time.perf_counter()
    snap = pool.state
    standby = FilterPool(model, params, capacity=n, seed=7, replay_buckets=REPLAY_BUCKETS)
    standby.load_state(snap)
    times["state"].append(1e3 * (time.perf_counter() - t1))
    tail = [(pool.step(tick_inputs(sids, k)), standby.step(tick_inputs(sids, k)))
            for k in range(FLEET_TICKS + 1, FLEET_TICKS + 4)]
    run_s = time.perf_counter() - t0
    plan = plan_replay_chunks(int(lengths.max()), REPLAY_BUCKETS)
    k_prog = sum(kp for _, kp in plan)
    counts = read_launches(
        "filter_pool", FLEET_TICKS + 1 + k_prog + FORECAST_H + 6,
        f"{FLEET_TICKS} ticks + 1 hold tick + replay chunks {plan} + forecast H {FORECAST_H} "
        "+ 3 ticks on the pool and 3 on its standby")

    # the references, after the counted run
    for k, out in enumerate(ticks):
        for s in sids:
            check_moments(f"filter_pool tick {k}", *out[s], (2,))
    for s in sids:
        check_moments("filter_pool forecast", *fc[s], (FORECAST_H, 2))
    sf = StreamingFilter(model, params, batch=n)
    sf.start(u_all[:n, :r], y_all[:n, :r])
    init_err = float(np.abs(sf.state[0] - x0[0]).max())
    if not np.allclose(sf.state[0], x0[0], rtol=1e-4, atol=1e-5):
        fail(f"filter_pool: 32 attaches vs a batch-32 start differ by {init_err:.3e}")
    sf.load_state((x0[0], 0, x0[4]))
    for k, out in enumerate(ticks):
        mean, var = (host(a) for a in sf.update(u_all[:n, r - 1 + k], y_all[:n, r + k]))
        if not all(same_pair(out[s], (mean[i], var[i])) for i, s in enumerate(sids)):
            fail(f"filter_pool: tick {k} differs from the batch-32 StreamingFilter")
    if not np.array_equal(sf.state[0], after_lockstep[0]):
        fail("filter_pool: 20 lockstep ticks differ from the batch-32 StreamingFilter")
    moved = np.abs(after_hold[0] - after_lockstep[0]).reshape(n, -1).max(axis=1)
    if set(held) != set(sids[1::2]) or moved[0::2].any() or not moved[1::2].all():
        fail("filter_pool: the hold tick moved a held row or held a stepped one")
    seq_pool = FilterPool(model, params, capacity=n)
    seq_pool.load_state(after_hold)
    seq = {s: [] for s in sids}
    for t in range(int(lengths.max())):
        out = seq_pool.step({s: (backlog[s][0][t], backlog[s][1][t])
                             for i, s in enumerate(sids) if lengths[i] > t})
        for s, mv in out.items():
            seq[s].append(mv)
    for s in sids:
        want = tuple(np.stack([mv[i] for mv in seq[s]]) for i in (0, 1))
        if not same_pair(replayed[s], want):
            fail(f"filter_pool: session {s}'s ragged replay differs from the tick-by-tick "
                 "schedule")
    if not np.array_equal(seq_pool.state[0], after_replay[0]) or \
            seq_pool.state[1] != after_replay[1]:
        fail("filter_pool: the replayed ensemble differs from the tick-by-tick one")
    if not all(same_pair(a[s], b[s]) for a, b in tail for s in sids):
        fail("filter_pool: the seed-7 standby restored from state differs from the pool")
    # the kernel path against solve_free, float64 (after the counted run)
    outs = {}
    for impl in ("pallas", "solve_free"):
        m64 = rnn_model(type(model), "float64", impl)
        p64 = FilterPool(m64, params.to(torch.float64), capacity=n)
        s64 = [p64.attach(u_all[i, :r], y_all[i, :r]) for i in range(n)]
        outs[impl] = [p64.step(tick_inputs(s64, k)) for k in range(5)]
        outs[impl].append(p64.forecast({s: u_all[i, r + 5:r + 15] for i, s in enumerate(s64)}))
    f64_err = 0.0
    for a, b in zip(outs["pallas"], outs["solve_free"]):
        for s in a:
            for x, z in zip(a[s], b[s]):
                f64_err = max(f64_err, float(np.abs(x - z).max()))
                if not np.allclose(x, z, rtol=1e-8, atol=1e-10):
                    fail(f"filter_pool float64: kernel path vs solve_free differ by "
                         f"{np.abs(x - z).max():.3e}")
    print(f"filter_pool: {n} attaches, {FLEET_TICKS} lockstep ticks, a hold tick, a ragged "
          f"replay (lengths {int(lengths.min())}-{int(lengths.max())}, chunks {plan}), forecast "
          f"H {FORECAST_H}, state into a seed-7 standby and 3 ticks of each, in {run_s:.2f} s; "
          f"ticks equal to a batch-{n} StreamingFilter from the same ensemble (the batch-{n} "
          f"start within {init_err:.2e}), held rows unmoved, replay and standby bitwise; "
          f"float64 kernel path vs solve_free max abs diff {f64_err:.3e} (rtol 1e-8); "
          f"gp_predict launches {counts[0]}", flush=True)
    print(f"latency filter_pool ({n} sessions, N = {n * model.samples} rows, float32, host ms): "
          f"tick {fmt_times(times['tick'])}; hold tick {times['hold tick'][0]:.3f}; attach "
          f"{fmt_times(times['attach'])}; replay {times['replay'][0]:.3f}; forecast H "
          f"{FORECAST_H} {times['forecast'][0]:.3f}; state round trip {times['state'][0]:.3f}; "
          f"{card}", flush=True)
    return counts, pool.state


def recording_pool(*args, **kwargs):
    """A FilterPool that logs every attach (its window) and every step
    (its group of inputs) in ``log``, in dispatch order."""
    from cbfssm_tpu_torch.serving import FilterPool

    class RecordingPool(FilterPool):
        def attach(self, u_prefix, y_prefix):
            sid = super().attach(u_prefix, y_prefix)
            self.log.append(("attach", (u_prefix, y_prefix)))
            return sid

        def step(self, inputs):
            self.log.append(("step", dict(inputs)))
            return super().step(inputs)

    pool = RecordingPool(*args, **kwargs)
    pool.log = []
    return pool


def filter_http(model, params, u_all, y_all, card: str) -> tuple:
    """(c) An in-process ``FilterServer`` (capacity 32, a 10 ms window):
    16 client threads each attach a window and POST 20 steps. Every
    dispatch is recorded, and each reply must equal a bare pool replayed
    through the recorded attaches and groups, bitwise. Then ``GET
    /v1/state`` in JSON and in ``.npz``, each restored into a standby
    server of another seed, whose next tick must equal the primary's
    bitwise; last, ``POST /v1/params`` (a seed-1 init), after which the
    sessions keep their state. Returns the four launch counts:
    ``gp_predict`` 1 per pool step."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.serving import FilterPool
    from cbfssm_tpu_torch.serving_http import (FilterServer, get_state_npz, post_params_npz,
                                               post_state_npz)

    r = int(model.config.recog_len)
    first = 40  # the clients' test windows: 40..55
    replies = {k: [] for k in range(HTTP_CLIENTS)}
    lat, sids = [], [None] * HTTP_CLIENTS
    reset_launches()
    t0 = time.perf_counter()
    primary = recording_pool(model, params, capacity=FLEET)
    standby_pool = FilterPool(model, params, capacity=FLEET, seed=11)
    with FilterServer(primary, max_wait_ms=HTTP_WAIT_MS) as srv, \
            FilterServer(standby_pool, max_wait_ms=HTTP_WAIT_MS) as stb:
        srv.start()
        stb.start()
        base, sbase = f"http://{srv.host}:{srv.port}", f"http://{stb.host}:{stb.port}"
        barrier = threading.Barrier(HTTP_CLIENTS)

        def client(k):
            w = first + k
            code, out = http_json("POST", base + "/v1/sessions",
                                  {"u_prefix": u_all[w, :r].tolist(),
                                   "y_prefix": y_all[w, :r].tolist()})
            if code != 200:
                replies[k].append(("attach", code, out))
                return
            sids[k] = out["sid"]
            barrier.wait(timeout=300)
            for j in range(HTTP_TICKS):
                t1 = time.perf_counter()
                code, out = http_json("POST", f"{base}/v1/sessions/{sids[k]}/step",
                                      {"u_prev": u_all[w, r - 1 + j].tolist(),
                                       "y_new": y_all[w, r + j].tolist()})
                lat.append(1e3 * (time.perf_counter() - t1))
                replies[k].append((j, code, out))

        threads = [threading.Thread(target=client, args=(k,)) for k in range(HTTP_CLIENTS)]
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall_ms = 1e3 * (time.perf_counter() - t1)
        if any(th.is_alive() for th in threads):
            fail("filter_http: clients did not finish")
        stats = srv.stats()
        n_client_ops = len(primary.log)

        def next_tick(url, sid, w):
            return http_json("POST", f"{url}/v1/sessions/{sid}/step",
                             {"u_prev": u_all[w, r + 30].tolist(),
                              "y_new": y_all[w, r + 31].tolist()})

        state_ms = {}
        t1 = time.perf_counter()
        code, snap = http_json("GET", base + "/v1/state")
        state_ms["GET json"] = 1e3 * (time.perf_counter() - t1)
        t1 = time.perf_counter()
        code2, ack = http_json("POST", sbase + "/v1/state", snap)
        state_ms["POST json"] = 1e3 * (time.perf_counter() - t1)
        if (code, code2, ack) != (200, 200, {"ok": True}):
            fail(f"filter_http: JSON failover answered {code} / {code2} {ack}")
        if next_tick(sbase, sids[0], first) != next_tick(base, sids[0], first):
            fail("filter_http: the standby's tick after the JSON restore differs")
        t1 = time.perf_counter()
        blob = get_state_npz(base, timeout=300)
        state_ms["GET npz"] = 1e3 * (time.perf_counter() - t1)
        t1 = time.perf_counter()
        post_state_npz(sbase, blob, timeout=300)
        state_ms["POST npz"] = 1e3 * (time.perf_counter() - t1)
        if next_tick(sbase, sids[1], first + 1) != next_tick(base, sids[1], first + 1):
            fail("filter_http: the standby's tick after the .npz restore differs")
        before = srv.batcher.state().result(timeout=300)
        new = model.init(torch.Generator(device=DEVICE).manual_seed(1))
        t1 = time.perf_counter()
        post_params_npz(base, new, timeout=300)
        swap_ms = 1e3 * (time.perf_counter() - t1)
        after = srv.batcher.state().result(timeout=300)
        if not (np.array_equal(before[0], after[0]) and before[1:4] == after[1:4]):
            fail("filter_http: the /v1/params swap changed the sessions' state")
        code, out = next_tick(base, sids[2], first + 2)
        if code != 200:
            fail(f"filter_http: a step after the swap answered {code}: {out}")
        check_moments("filter_http step after the swap", out["mean"], out["var"], (2,))
    run_s = time.perf_counter() - t0
    n_steps = sum(kind == "step" for kind, _ in primary.log)
    counts = read_launches("filter_http", n_steps + 2,
                           f"{n_steps} primary pool steps + 2 standby ticks")

    # every client reply against a bare pool fed the recorded operations
    bare, remap, want = FilterPool(model, params, capacity=FLEET), {}, {}
    n_seen = {}
    attaches = 0
    for kind, payload in primary.log[:n_client_ops]:
        if kind == "attach":
            remap[attaches] = bare.attach(*payload)
            attaches += 1
            continue
        out = bare.step({remap[s]: v for s, v in payload.items()})
        for s in payload:
            j = n_seen.get(s, 0)
            n_seen[s] = j + 1
            want[(s, j)] = out[remap[s]]
    for k in range(HTTP_CLIENTS):
        if len(replies[k]) != HTTP_TICKS or sids[k] is None:
            fail(f"filter_http: client {k} got {replies[k][:1]} ...")
        for j, code, out in replies[k]:
            if code != 200:
                fail(f"filter_http: client {k} tick {j} answered {code}: {out}")
            got = (np.asarray(out["mean"], np.float32), np.asarray(out["var"], np.float32))
            if not same_pair(got, want[(sids[k], j)]):
                fail(f"filter_http: client {k} tick {j} differs from the bare pool's replay of "
                     "the recorded dispatches")
    n_disp = n_steps - 3  # the three ticks after the clients
    print(f"filter_http: {HTTP_CLIENTS} clients x {HTTP_TICKS} steps over HTTP in {n_disp} "
          f"dispatches (mean group {HTTP_CLIENTS * HTTP_TICKS / n_disp:.2f}, max "
          f"{stats['max_group_seen']}), every reply equal to a bare pool replaying the recorded "
          f"dispatches; JSON and .npz failover to a seed-11 standby bitwise; /v1/params swap "
          f"keeps the sessions; {run_s:.2f} s; gp_predict launches {counts[0]} = {n_steps} + 2",
          flush=True)
    print(f"latency filter_http (float32, host ms): step round trip {fmt_times(lat)}; "
          f"{HTTP_CLIENTS} x {HTTP_TICKS} steps in {wall_ms:.2f} ms wall "
          f"({1e3 * HTTP_CLIENTS * HTTP_TICKS / wall_ms:.1f} steps/s); /v1/state "
          + ", ".join(f"{k} {v:.2f}" for k, v in state_ms.items())
          + f"; /v1/params {swap_ms:.2f}; {card}", flush=True)
    return counts


def filter_fleet_1024(model, params, fleet_state, u_all, y_all, card: str) -> tuple:
    """(d) A 1,024-session fleet (N = 51,200 rows a tick): a
    ``FilterServer(capacity=1024)`` filled by ``POST /v1/state`` of (b)'s
    32 ensembles tiled 32 times, ``GET`` and ``POST`` of ``/v1/state``
    timed in JSON and ``.npz``, then 5 ticks with every session active,
    submitted through the server's FilterBatcher (a 50 ms window). After
    the counted run, a bare ``FilterPool(capacity=1024)`` loaded with the
    same snapshot replays the recorded step groups, and every reply of
    every tick must equal its replay bitwise. Returns the four launch
    counts: ``gp_predict`` 1 per pool step."""
    import numpy as np

    from cbfssm_tpu_torch.serving import FilterPool
    from cbfssm_tpu_torch.serving_http import FilterServer, get_state_npz, post_state_npz

    r = int(model.config.recog_len)
    x32, tick, _, _, key = fleet_state
    reps = BIG_FLEET // FLEET
    snapshot = (np.tile(x32, (reps, 1, 1)), tick, {i: i for i in range(BIG_FLEET)},
                BIG_FLEET, key)
    reset_launches()
    t0 = time.perf_counter()
    pool = recording_pool(model, params, capacity=BIG_FLEET)
    ms = {}
    with FilterServer(pool, max_wait_ms=50.0) as srv:
        srv.start()
        base = f"http://{srv.host}:{srv.port}"
        body = FilterServer._encode_state(snapshot)
        t1 = time.perf_counter()
        code, ack = http_json("POST", base + "/v1/state", body)
        ms["POST json"] = 1e3 * (time.perf_counter() - t1)
        if (code, ack) != (200, {"ok": True}):
            fail(f"filter_fleet_1024: POST /v1/state answered {code}: {ack}")
        t1 = time.perf_counter()
        code, snap = http_json("GET", base + "/v1/state")
        ms["GET json"] = 1e3 * (time.perf_counter() - t1)
        if code != 200 or not np.array_equal(np.asarray(snap["x"], np.float32), snapshot[0]):
            fail("filter_fleet_1024: GET /v1/state does not return the posted ensemble")
        t1 = time.perf_counter()
        blob = get_state_npz(base, timeout=300)
        ms["GET npz"] = 1e3 * (time.perf_counter() - t1)
        t1 = time.perf_counter()
        post_state_npz(base, blob, timeout=300)
        ms["POST npz"] = 1e3 * (time.perf_counter() - t1)
        sizes = (len(json.dumps(snap, separators=(",", ":"))), len(blob))
        tick_ms, outs = [], []
        for k in range(BIG_FLEET_TICKS):
            t1 = time.perf_counter()
            futs = [srv.batcher.step(i, u_all[i % len(u_all), r + 40 + k],
                                     y_all[i % len(u_all), r + 41 + k])
                    for i in range(BIG_FLEET)]
            outs.append([f.result(timeout=300) for f in futs])
            tick_ms.append(1e3 * (time.perf_counter() - t1))
        stats = srv.stats()
    run_s = time.perf_counter() - t0
    n_steps = sum(kind == "step" for kind, _ in pool.log)
    counts = read_launches("filter_fleet_1024", n_steps,
                           f"{n_steps} pool steps (dispatches of the {BIG_FLEET_TICKS} ticks)")
    for k, out in enumerate(outs):
        mean = np.stack([o[0] for o in out])
        var = np.stack([o[1] for o in out])
        check_moments(f"filter_fleet_1024 tick {k}", mean, var, (BIG_FLEET, 2))
    # every reply against a bare pool fed the same snapshot and the
    # recorded step groups (the table maps sid i to slot i in both)
    bare, want, n_seen = FilterPool(model, params, capacity=BIG_FLEET), {}, {}
    bare.load_state(snapshot)
    for _, payload in pool.log:
        out = bare.step(payload)
        for s in payload:
            want[(s, n_seen.get(s, 0))] = out[s]
            n_seen[s] = n_seen.get(s, 0) + 1
    for k, out in enumerate(outs):
        for i, got in enumerate(out):
            if not same_pair(got, want[(i, k)]):
                fail(f"filter_fleet_1024: session {i} tick {k} differs from the bare pool's "
                     "replay of the recorded dispatches")
    print(f"filter_fleet_1024: /v1/state filled {BIG_FLEET} sessions ({FLEET} ensembles x "
          f"{reps}); {BIG_FLEET_TICKS} ticks of all {BIG_FLEET} sessions in {n_steps} dispatches "
          f"(max group {stats['max_group_seen']}), every reply equal to a bare pool replaying "
          f"the recorded dispatches; {run_s:.2f} s; gp_predict launches {counts[0]}",
          flush=True)
    print(f"latency filter_fleet_1024 (float32, host ms): tick of {BIG_FLEET} sessions "
          f"{fmt_times(tick_ms)}; /v1/state ({sizes[0]} bytes JSON, {sizes[1]} bytes .npz) "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + f"; {card}", flush=True)
    return counts


def save_model_dir(model_dir: str, model, params):
    """A directory as a trainer leaves it: model_meta.json and best.ckpt."""
    import os

    from cbfssm_tpu_torch import model_store
    from cbfssm_tpu_torch.training import checkpoint

    model_store.save_model_meta(model_dir, model)
    checkpoint.save(os.path.join(model_dir, checkpoint.BEST), {"params": params.tensors()})


def cli_serve_filter(model, params, u_all, y_all, card: str) -> tuple:
    """(e) ``python -m cbfssm_tpu_torch serve --filter DIR --port 0``
    (:func:`serve_subprocess`) over a directory of the trained
    CBFSSMHALF: the banner, one attach and one step over HTTP (held
    against the same in this process at float32 tolerance: another
    process), then SIGTERM must end it with exit 0. Then ``serve
    --filter`` on a CBFSSM directory must exit 2. Returns the four
    launch counts the subprocess printed: ``gp_predict`` 1, its one
    step."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from cbfssm_tpu_torch import __main__ as cli
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.serving import FilterPool

    r = int(model.config.recog_len)
    direct_pool = FilterPool(model, params, capacity=32)
    sid = direct_pool.attach(u_all[0, :r], y_all[0, :r])
    direct = direct_pool.step({sid: (u_all[0, r - 1], y_all[0, r])})[sid]
    want_banner = (f"serving CBFSSMHALF filter sessions (capacity 32, recog_len {r}, dim_u 2, "
                   "dim_y 2, float32, auth off) on http://")

    def use(base):
        t1 = time.perf_counter()
        code, out = http_json("POST", base + "/v1/sessions", {
            "u_prefix": u_all[0, :r].tolist(), "y_prefix": y_all[0, :r].tolist()})
        code2, step = http_json("POST", f"{base}/v1/sessions/{out.get('sid')}/step",
                                {"u_prev": u_all[0, r - 1].tolist(), "y_new": y_all[0, r].tolist()})
        first_ms = 1e3 * (time.perf_counter() - t1)
        if (code, code2) != (200, 200):
            fail(f"CLI serve --filter: attach / step answered {code} / {code2}: {step}")
        err = max(float(np.abs(np.asarray(step[k]) - direct[i]).max())
                  for i, k in enumerate(("mean", "var")))
        if not all(np.allclose(step[k], direct[i], rtol=1e-5, atol=1e-6)
                   for i, k in enumerate(("mean", "var"))):
            fail(f"CLI serve --filter: the step differs from this process's by {err:.3e}")
        return first_ms, err

    dev = [] if DEVICE == "cuda" else ["--device", DEVICE]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        half_dir, cbfssm_dir = os.path.join(tmp, "half"), os.path.join(tmp, "cbfssm")
        save_model_dir(half_dir, model, params)
        banner, ready_s, (first_ms, err), counts = serve_subprocess(
            ["serve", "--filter", half_dir], tmp, "CLI serve --filter", use)
        if not banner.startswith(want_banner):
            fail(f"CLI serve --filter: banner {banner!r}, want {want_banner!r}...")
        cbfssm = CBFSSM(config("float32", "pallas"), device=DEVICE)
        save_model_dir(cbfssm_dir, cbfssm,
                       cbfssm.init(torch.Generator(device=DEVICE).manual_seed(0)))
        msg = io.StringIO()
        with contextlib.redirect_stderr(msg):
            rc2 = cli.main(["serve", "--filter", cbfssm_dir, *dev])
        if rc2 != 2 or "CBFSSM has no streaming interface" not in msg.getvalue():
            fail(f"CLI serve --filter on a CBFSSM directory: exit {rc2}, {msg.getvalue()!r}")
    if counts != (1, 0, 0, 0):
        fail(f"CLI serve --filter: {COUNTERS} launches {counts} != (1, 0, 0, 0): one step")
    print(f"CLI serve --filter: {banner}; ready in {ready_s:.2f} s, attach + step "
          f"{first_ms:.2f} ms (max abs diff to this process {err:.3e}); SIGTERM: exit 0; "
          f"gp_predict launches {counts[0]}; on a CBFSSM directory: exit 2 "
          f"({msg.getvalue().strip()[:80]}); {card}", flush=True)
    return counts


def filter_voliro(card: str) -> tuple:
    """(f) Voliro (run_voliro.py's config, B 1 / 8, S 20, M 20, with
    ``filter_dt`` 0.01) on a synthetic flip log: a ``StreamingFilter``
    (start, 5 updates, forecast H 10, the start state replayed 5 steps
    in a padded chunk of 8, equal to the updates bitwise) and a
    ``FilterPool(capacity=8)`` (8 attaches, 3 ticks, forecast H 10, a
    ragged replay of 1-8 steps). Voliro's ``filter_init`` launches
    nothing; each step predicts its force GP once (N = B). Then the
    kernel path against ``solve_free`` in float64 at rtol 1e-8. Returns
    the four launch counts."""
    import os
    import tempfile

    import numpy as np
    import torch

    from cbfssm_tpu_torch import run_voliro
    from cbfssm_tpu_torch.data import VoliroFlipDS, synthetic
    from cbfssm_tpu_torch.models import Voliro
    from cbfssm_tpu_torch.serving import FilterPool, StreamingFilter

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as data_dir:
        for name, (n, offset) in synthetic.VOLIRO_LOGS.items():
            synthetic.voliro_log(os.path.join(data_dir, name), n=n, seed=offset)
        ds = VoliroFlipDS(run_voliro.seq_len, run_voliro.seq_stride, data_dir=data_dir)
    u_log, y_log = ds.test_in[0], ds.test_out[0]

    def make_model(dtype, impl):
        return Voliro(dict(run_voliro.model_config, dtype=dtype, gp_impl=impl, filter_dt=0.01),
                      device=DEVICE)

    model = make_model("float32", "pallas")
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    r, h, k_n = int(model.config.recog_len), 10, 5
    starts = [140 * i for i in range(VOLIRO_POOL)]  # the test log holds ~1,280 steps
    lengths = np.arange(1, VOLIRO_POOL + 1)

    def run(m, p):
        f = StreamingFilter(m, p, batch=1, replay_buckets=(8,))
        f.start(u_log[None, :r], y_log[None, :r])
        snap = f.state
        seq = [f.update(u_log[None, r - 1 + k], y_log[None, r + k]) for k in range(k_n)]
        fc = f.forecast(u_log[None, r + k_n:r + k_n + h])
        g = StreamingFilter(m, p, batch=1, seed=3, replay_buckets=(8,))
        g.load_state(snap)
        rep = g.replay(u_log[None, r - 1:r - 1 + k_n], y_log[None, r:r + k_n])
        pool = FilterPool(m, p, capacity=VOLIRO_POOL)
        sids = [pool.attach(u_log[s:s + r], y_log[s:s + r]) for s in starts]
        ticks = [pool.step({sid: (u_log[s + r - 1 + k], y_log[s + r + k])
                            for sid, s in zip(sids, starts)}) for k in range(3)]
        pfc = pool.forecast({sid: u_log[s + r + 3:s + r + 3 + h] for sid, s in zip(sids, starts)})
        prep = pool.replay({sid: (u_log[s + r + 2:s + r + 2 + kk], y_log[s + r + 3:s + r + 3 + kk])
                            for sid, s, kk in zip(sids, starts, lengths)})
        return seq, fc, rep, f, g, ticks, pfc, prep

    reset_launches()
    t0 = time.perf_counter()
    seq, fc, rep, f, g, ticks, pfc, prep = run(model, params)
    run_s = time.perf_counter() - t0
    counts = read_launches(
        "filter_voliro", k_n + h + 8 + 3 + h + int(lengths.max()),
        f"{k_n} updates + forecast H {h} + a replay chunk of 8 + 3 pool ticks + forecast H {h} "
        f"+ a pool replay of {int(lengths.max())} steps (filter_init: 0)")
    for k, (mean, var) in enumerate(seq):
        check_moments(f"filter_voliro update {k}", mean, var, (1, 7))
    check_moments("filter_voliro forecast", *fc, (1, h, 7))
    for out in (*ticks, pfc, prep):
        for sid, (mean, var) in out.items():
            check_moments("filter_voliro pool", mean, var, mean.shape)
    seq_mv = tuple(np.stack([host(s[i]) for s in seq], axis=1) for i in (0, 1))
    if not same_pair(rep, seq_mv) or not np.array_equal(g.state[0], f.state[0]):
        fail("filter_voliro: the padded replay differs from the sequential updates")
    outs = {}
    for impl in ("pallas", "solve_free"):
        m64 = make_model("float64", impl)
        seq64, fc64, _, _, _, ticks64, pfc64, prep64 = run(m64, params.to(torch.float64))
        outs[impl] = [tuple(host(a) for a in mv) for mv in (*seq64, fc64)] + \
            [mv for out in (*ticks64, pfc64, prep64) for mv in out.values()]
    f64_err = 0.0
    for a, b in zip(outs["pallas"], outs["solve_free"]):
        for x, z in zip(a, b):
            f64_err = max(f64_err, float(np.abs(x - z).max()))
            if not np.allclose(x, z, rtol=1e-8, atol=1e-10):
                fail(f"filter_voliro float64: kernel path vs solve_free differ by "
                     f"{np.abs(x - z).max():.3e}")
    print(f"filter_voliro: StreamingFilter (start, {k_n} updates, forecast H {h}, a {k_n}-step "
          f"replay padded to 8, equal to the updates bitwise) and FilterPool({VOLIRO_POOL}) "
          f"(attaches, 3 ticks, forecast H {h}, ragged replay 1-{int(lengths.max())}) in "
          f"{run_s:.2f} s; float64 kernel path vs solve_free max abs diff {f64_err:.3e} "
          f"(rtol 1e-8); gp_predict launches {counts[0]}; {card}", flush=True)
    return counts


def phase_filters(card: str, params=None):
    """Phase 10: online filtering at the RoboMove phase-0 width
    (CBFSSMHALF, 'rnn', S 50, M 100, dim_x 4, float32, 'pallas', phase
    6's trained ``params``; a seed-0 init without them) on RoboMove test
    windows, then Voliro. Each part sets the launch counts to 0 just
    before its main path and reads them just after. Returns the
    filter-shape kernel figures and the launches by path."""
    import torch

    from cbfssm_tpu_torch.models import CBFSSMHALF

    model = rnn_model(CBFSSMHALF, "float32", "pallas")
    if params is None:
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    u_all, y_all = served_windows()
    (ROOT / "build").mkdir(exist_ok=True)
    paths = {}
    t0 = time.perf_counter()
    paths["filter_stream"] = filter_stream(model, params, u_all, y_all, card)
    paths["filter_pool"], fleet_state = filter_fleet(model, params, u_all, y_all, card)
    paths["filter_http"] = filter_http(model, params, u_all, y_all, card)
    paths["filter_fleet_1024"] = filter_fleet_1024(model, params, fleet_state, u_all, y_all,
                                                   card)
    kernels = phase_filter_kernels()
    paths["cli_serve_filter"] = cli_serve_filter(model, params, u_all, y_all, card)
    paths["filter_voliro"] = filter_voliro(card)
    print(f"filters: launches by path {paths}; {time.perf_counter() - t0:.2f} s", flush=True)
    return kernels, paths


@contextlib.contextmanager
def timed_saves(seconds: list):
    """Appends the seconds of every ``torch.export.save`` inside the block
    to ``seconds`` (an export's save, apart from its trace)."""
    import torch

    save = torch.export.save

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return save(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    torch.export.save = timed
    try:
        yield
    finally:
        torch.export.save = save


def background_serve(args: list, log_dir: str, where: str, use):
    """:func:`serve_subprocess` on a thread of its own, so the served
    process loads while this one works. Returns a function that waits for
    it and returns its result (a failure in the thread fails the run)."""
    out, errors = [], []

    def run():
        try:
            out.append(serve_subprocess(args, log_dir, where, use))
        except (Exception, SystemExit) as e:  # fail() exits with SystemExit
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join(timeout=900)
        if thread.is_alive():
            fail(f"{where}: the serving subprocess did not finish")
        if errors:
            fail(f"{where}: {errors[0]!r}")
        return out[0]

    return join


# a second load of an artifact in a new process on the same compile
# cache: its load seconds and Inductor's cache counters
WARM_LOAD = (
    "import json, sys, time\n"
    "import torch\n"
    "from torch._dynamo.utils import counters\n"
    "from cbfssm_tpu_torch.export import ExportedPredictor\n"
    "t0 = time.perf_counter()\n"
    "pred = ExportedPredictor(sys.argv[1], device=sys.argv[2])\n"
    "if sys.argv[2] == 'cuda':\n"
    "    torch.cuda.synchronize()\n"
    "print(json.dumps({'load_s': time.perf_counter() - t0, 'compiled': pred.compiled is not None,"
    " 'counters': {k: dict(counters[k]) for k in ('inductor', 'aot_autograd')}}))\n")


def warm_load(path: str) -> dict:
    """:data:`WARM_LOAD` in its own process (it inherits the cache's
    ``CBFSSM_XLA_CACHE``)."""
    proc = subprocess.run([sys.executable, "-c", WARM_LOAD, path, DEVICE], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"warm load: exit {proc.returncode}; stderr {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def program_call(pred, u, y, seed: int):
    """The uncompiled program of an ``ExportedPredictor`` on the draws
    of ``seed``: the call before compile-at-load."""
    import torch

    kw = dict(dtype=pred.dtype, device=pred.device)
    with torch.no_grad():
        return pred.program(pred._params, torch.as_tensor(u, **kw), torch.as_tensor(y, **kw),
                            tuple(pred._draw_noise(seed)))


def reply_field(out, f: str):
    """Field ``f`` of a reply: a dict (an artifact's) or a PredictOutput."""
    return out[f] if isinstance(out, dict) else getattr(out, f)


def max_abs(outs, refs, fields) -> float:
    """The largest |a - b| over the fields of two lists of replies."""
    return max(float((reply_field(o, f) - reply_field(r, f)).abs().max())
               for o, r in zip(outs, refs) for f in fields)


def all_close(outs, refs, fields, rtol: float, atol: float) -> bool:
    import torch

    return all(torch.allclose(reply_field(o, f), reply_field(r, f), rtol=rtol, atol=atol)
               for o, r in zip(outs, refs) for f in fields)


def export_predictor_f64(card: str, tmp: str) -> None:
    """(a') A float64 CBFSSM predictor at the full width and a small
    depth (``EXPORT_RECOG_F64``, ``EXPORT_SEQ_F64``), compiled at load: its
    replies at seeds 0-1 within rtol 1e-12 of the live predictor's and
    of the uncompiled program's. Not a main path: uncounted."""
    import os

    import torch

    from cbfssm_tpu_torch.export import ExportedPredictor, save_exported_predictor
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.serving import CompiledPredictor

    model = CBFSSM(config("float64", "pallas", recog_len=EXPORT_RECOG_F64), device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    u_all, y_all = (a[:1, :EXPORT_SEQ_F64] for a in served_windows())
    path = os.path.join(tmp, "predictor_f64")
    save_exported_predictor(path, model, params, 1, EXPORT_SEQ_F64)
    t0 = time.perf_counter()
    pred = ExportedPredictor(path, device=DEVICE)
    load_s = time.perf_counter() - t0
    if DEVICE == "cuda" and pred.compiled is None:
        fail("export_predictor_f64: the artifact was not compiled at load")
    live = CompiledPredictor(model, params, 1, EXPORT_SEQ_F64)
    fields = pred.meta["output_fields"]
    outs = [pred(u_all, y_all, s) for s in range(2)]
    raws = [program_call(pred, u_all, y_all, s) for s in range(2)]
    refs = [live(u_all, y_all, s) for s in range(2)]
    err, err_raw = max_abs(outs, refs, fields), max_abs(outs, raws, fields)
    if not (all_close(outs, refs, fields, 1e-12, 1e-13)
            and all_close(outs, raws, fields, 1e-12, 1e-13)):
        fail(f"export_predictor_f64: compiled replies differ from live by {err:.3e} and from "
             f"the uncompiled program by {err_raw:.3e} (max abs; rtol 1e-12, atol 1e-13)")
    print(f"export_predictor_f64: CBFSSM B=1 T={EXPORT_SEQ_F64} recog_len {EXPORT_RECOG_F64} "
          f"float64 compiled "
          f"at load in {load_s:.2f} s (a graph new to the cache, in the cold-compile process); "
          f"replies at seeds 0-1 within "
          f"{err:.3e} of live and {err_raw:.3e} of the uncompiled program (max abs; rtol "
          f"1e-12, atol 1e-13); {card}", flush=True)


# phase 11's cold compile runs in a process of its own, started after
# phase 4 and running beside phases 5-10, so that its minutes do not add
# to the script's: (a)'s export and first, cold load, and (a')
COLD_COMPILE = ("import json, sys\n"
                "sys.path.insert(0, sys.argv[1])\n"
                "import chip_smoke\n"
                "chip_smoke.DEVICE = sys.argv[3]\n"
                "print('RESULT ' + json.dumps(chip_smoke.cold_compile(sys.argv[2], sys.argv[4])),"
                " flush=True)\n")
COLD_COMPILE_THREADS = 4  # Inductor's compile workers there: the other phases keep cores


def build_tempdir() -> str:
    """A new directory under ``build/``, removed when this script exits."""
    import atexit
    import shutil
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    return tmp


def kill_at_exit(proc) -> None:
    """Kills ``proc`` when this script exits, if it still runs."""
    import atexit

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)

    atexit.register(stop)


def start_cold_compile(card: str) -> dict:
    """Starts :func:`cold_compile` in its own process on a new directory
    under ``build/`` (its compile cache a fresh ``compile_cache`` there),
    output to a log file."""
    import os

    tmp = build_tempdir()
    env = dict(os.environ, CBFSSM_XLA_CACHE=os.path.join(tmp, "compile_cache"),
               TORCHINDUCTOR_COMPILE_THREADS=str(COLD_COMPILE_THREADS))
    for name in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        env.pop(name, None)
    log = open(os.path.join(tmp, "cold_compile.txt"), "w+")
    proc = subprocess.Popen([sys.executable, "-c", COLD_COMPILE, str(ROOT), tmp, DEVICE, card],
                            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True, env=env)
    kill_at_exit(proc)
    return {"proc": proc, "tmp": tmp, "log": log, "t0": time.perf_counter()}


def cold_compile(tmp: str, card: str) -> dict:
    """(a)'s first half and (a'), in the process of
    :func:`start_cold_compile`: the CBFSSM predictor at B 1, seq
    ``EXPORT_SEQ`` exported from phase 4's params (seed-0 init; its
    export and save seconds apart), then loaded once through
    ``ExportedPredictor`` on the fresh compile cache (``CBFSSM_XLA_CACHE``):
    the cold load, which must compile; then the float64 artifact
    (:func:`export_predictor_f64`). Returns the path, the seconds, the
    program's size and the cold load's cache counters."""
    import os

    import torch
    from torch._dynamo.utils import counters

    from cbfssm_tpu_torch.export import ExportedPredictor, save_exported_predictor
    from cbfssm_tpu_torch.models import CBFSSM

    model = CBFSSM(config("float32", "pallas"), device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    path = os.path.join(tmp, "predictor")
    saves = []
    t0 = time.perf_counter()
    with timed_saves(saves):
        save_exported_predictor(path, model, params, 1, EXPORT_SEQ)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = ExportedPredictor(path, device=DEVICE)
    sync()
    cold_s = time.perf_counter() - t0
    if DEVICE == "cuda" and pred.compiled is None:
        fail("cold compile: the artifact was not compiled at load on the card")
    out = {"path": path, "export_s": export_s - sum(saves), "save_s": sum(saves),
           "mb": os.path.getsize(os.path.join(path, "predictor.pt2")) / 1e6, "cold_s": cold_s,
           "counters": {k: dict(counters[k]) for k in ("inductor", "aot_autograd")}}
    export_predictor_f64(card, tmp)
    return out


def join_cold_compile(cold: dict) -> dict:
    """Waits for :func:`cold_compile`'s process and returns its result,
    after echoing its other lines (the float64 artifact's)."""
    proc, log = cold["proc"], cold["log"]
    try:
        proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        fail("cold compile: the process did not finish")
    log.seek(0)
    lines = log.read().splitlines()
    log.close()
    if proc.returncode != 0:
        fail(f"cold compile: exit {proc.returncode}; {chr(10).join(lines[-30:])}")
    result = next(json.loads(ln[len("RESULT "):]) for ln in lines if ln.startswith("RESULT "))
    for ln in lines:
        if ln.startswith("export_predictor_f64"):
            print(ln, flush=True)
    result["wall_s"] = time.perf_counter() - cold["t0"]
    return result


def export_predictor(card: str, tmp: str, cold: dict) -> dict:
    """(a) + (b): the CBFSSM predictor at B 1, seq 120 that
    :func:`cold_compile` exported and first loaded (cold) in its own
    process, loaded here through ``ExportedBatchPredictor`` on the same
    compile cache, which it must hit (warm), as must a load in a new
    process. Its program holds one ``gp_predict`` node per launch of the
    rule (219); 5 compiled calls at seeds 0-4 launch 5 x 219 (counted),
    each reply within rtol 2e-5 of ``CompiledPredictor``'s at the seed
    and of the uncompiled program's, which stays bitwise equal to
    ``CompiledPredictor``'s. Request ms of the three in turns. ``serve
    <artifact>`` in a subprocess (b), on the warm cache, answers 2
    requests, each bitwise equal to this process's compiled artifact at
    the dispatch seed ``fold_seed(0, k)``, with 3 x 219 launches (its
    load's call and the 2 requests). Returns the launches by path."""
    import os
    import statistics

    import numpy as np
    import torch
    from torch._dynamo.utils import counters

    from cbfssm_tpu_torch.export import gp_predict_nodes
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.serving import CompiledPredictor, fold_seed
    from cbfssm_tpu_torch.serving_http import ExportedBatchPredictor
    from cbfssm_tpu_torch.utils import compile_cache

    first = join_cold_compile(cold)
    path = first["path"]
    cache = os.path.join(cold["tmp"], "compile_cache")
    os.environ["CBFSSM_XLA_CACHE"] = cache  # this process's loads and the subprocesses'
    if not compile_cache.enable_persistent_cache(cache):
        fail(f"export_predictor: the compile cache did not take {cache}")
    model = CBFSSM(config("float32", "pallas"), device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    u_all, y_all = (a[:, :EXPORT_SEQ] for a in served_windows())
    rule = cbfssm_predict_launches(EXPORT_SEQ, int(model.config.recog_len))

    before = {k: dict(counters[k]) for k in ("inductor", "aot_autograd")}
    t0 = time.perf_counter()
    ebp = ExportedBatchPredictor(path, device=DEVICE)
    here_s = time.perf_counter() - t0
    pred, meta = ebp._pred, ebp.meta
    here = {k: {n: v - before[k].get(n, 0) for n, v in counters[k].items()}
            for k in ("inductor", "aot_autograd")}
    if DEVICE == "cuda" and (pred.compiled is None
                             or here["aot_autograd"].get("autograd_cache_hit", 0) < 1
                             or here["aot_autograd"].get("autograd_cache_miss", 0)
                             or here["inductor"].get("fxgraph_cache_miss", 0)):
        fail(f"export_predictor: this process's load did not hit the compile cache: {here}")
    nodes = gp_predict_nodes(pred.program)
    if nodes != rule:
        fail(f"export_predictor: {nodes} gp_predict nodes in the program, the rule is {rule}")
    # the warm load and the served process start together, on the warm
    # cache, while this process works
    warm_out, warm_errors = [], []

    def run_warm():
        try:
            warm_out.append(warm_load(path))
        except (Exception, SystemExit) as e:  # fail() exits with SystemExit
            warm_errors.append(e)

    warm_thread = threading.Thread(target=run_warm, daemon=True)
    warm_thread.start()
    ready, expected = threading.Event(), []

    def use(base):
        if not ready.wait(timeout=600):
            return None
        replies = []
        for k in range(len(expected)):
            code, reply = http_json("POST", base + "/v1/predict",
                                    {"u": u_all[k].tolist(), "y": y_all[k].tolist()})
            replies.append((code, reply))
        return replies

    join = background_serve(["serve", path], tmp, "CLI serve <artifact>", use)
    u1, y1 = u_all[:1], y_all[:1]
    reset_launches()
    outs = [pred(u1, y1, s) for s in range(EXPORT_REQUESTS)]
    counts = read_launches("export_predictor", EXPORT_REQUESTS * rule,
                           f"{EXPORT_REQUESTS} calls x {nodes} gp_predict nodes")
    live = CompiledPredictor(model, params, 1, EXPORT_SEQ)
    refs = [live(u1, y1, s) for s in range(EXPORT_REQUESTS)]
    raws = [program_call(pred, u1, y1, s) for s in range(EXPORT_REQUESTS)]
    fields = meta["output_fields"]
    for out in outs:
        for f in fields:
            if not bool(torch.isfinite(out[f]).all()):
                fail(f"export_predictor: {f} is not finite")
        if tuple(out["pred_mean"].shape) != (1, EXPORT_SEQ, 2):
            fail(f"export_predictor: pred_mean of shape {tuple(out['pred_mean'].shape)}")
    raw_bitwise = all(torch.equal(o[f], getattr(r, f)) for o, r in zip(raws, refs)
                      for f in fields)
    if not raw_bitwise:
        fail(f"export_predictor: the uncompiled program differs from CompiledPredictor by "
             f"{max_abs(raws, refs, fields):.3e}")
    err, err_raw = max_abs(outs, refs, fields), max_abs(outs, raws, fields)
    if not (all_close(outs, refs, fields, 2e-5, 1e-6) and all_close(outs, raws, fields, 2e-5,
                                                                    1e-6)):
        fail(f"export_predictor: the compiled artifact differs from CompiledPredictor by "
             f"{err:.3e} and from the uncompiled program by {err_raw:.3e} (max abs; rtol 2e-5, "
             "atol 1e-6)")
    # request ms of the three, in turns (uncounted)
    calls = {"compiled": lambda s: pred(u1, y1, s),
             "uncompiled": lambda s: program_call(pred, u1, y1, s),
             "live": lambda s: live(u1, y1, s)}
    times = {k: [] for k in calls}
    for r in range(EXPORT_REQUESTS):
        for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            sync()
            timed_call(times[k], calls[k], r)
    # (b) what the served process must answer: dispatch k at fold_seed(0, k)
    expected.extend(ebp(u_all[k:k + 1], y_all[k:k + 1], fold_seed(0, k)) for k in range(2))
    ready.set()
    warm_thread.join(timeout=900)
    if warm_thread.is_alive() or warm_errors:
        fail(f"warm load: {warm_errors[0] if warm_errors else 'did not finish'!r}")
    warm = warm_out[0]
    hits = warm["counters"]["aot_autograd"].get("autograd_cache_hit", 0)
    misses = (warm["counters"]["aot_autograd"].get("autograd_cache_miss", 0)
              + warm["counters"]["inductor"].get("fxgraph_cache_miss", 0))
    if DEVICE == "cuda" and (not warm["compiled"] or hits < 1 or misses):
        fail(f"export_predictor: the warm load compiled again: {warm}")
    banner, ready_s, replies, sub_counts = join()
    if replies is None or any(code != 200 for code, _ in replies):
        fail(f"CLI serve <artifact>: replies {str(replies)[:300]}")
    http_bitwise = all(
        np.array_equal(np.asarray(reply[f], dtype=np.float32), getattr(want, f)[0])
        for (_, reply), want in zip(replies, expected) for f in ("pred_mean", "pred_var", "sde"))
    http_err = max(float(np.abs(np.asarray(reply[f]) - getattr(want, f)[0]).max())
                   for (_, reply), want in zip(replies, expected) for f in ("pred_mean", "pred_var"))
    if not http_bitwise:
        fail(f"CLI serve <artifact>: replies differ from this process's compiled artifact by "
             f"{http_err:.3e}")
    if sub_counts != (3 * rule, 0, 0, 0):
        fail(f"CLI serve <artifact>: {COUNTERS} launches {sub_counts} != ({3 * rule}, 0, 0, 0) "
             "(the load's call and 2 requests)")
    print(f"export_predictor: CBFSSM B=1 T={EXPORT_SEQ} float32 exported in "
          f"{first['export_s']:.2f} s and saved in {first['save_s']:.2f} s "
          f"({first['mb']:.2f} MB); {nodes} gp_predict nodes = the rule "
          f"{rule}; {EXPORT_REQUESTS} compiled calls launch {counts[0]}; replies vs "
          f"CompiledPredictor at seeds 0-{EXPORT_REQUESTS - 1}: compiled within {err:.3e} "
          f"(max abs; rtol 2e-5, atol 1e-6), {err_raw:.3e} of the uncompiled program, which is "
          f"bitwise {raw_bitwise}", flush=True)
    print(f"compile at load export_predictor: cold {first['cold_s']:.2f} s (a fresh cache, in "
          f"the cold-compile process beside phases 5-10 with {COLD_COMPILE_THREADS} compile "
          f"workers; that process's export, load and float64 artifact {first['wall_s']:.2f} s of "
          f"wall time; cache counters {first['counters']}); warm {here_s:.2f} s in this "
          f"process ({here}) and {warm['load_s']:.2f} s in a new process beside the served "
          f"process's load ({warm['counters']}); {card}", flush=True)
    print(f"latency export_predictor (B=1, float32, host ms, median of {EXPORT_REQUESTS}, in "
          f"turns): " + ", ".join(
              f"{k} {statistics.median(v):.2f} ({', '.join(f'{t:.2f}' for t in v)})"
              for k, v in times.items()) + f"; {card}", flush=True)
    print(f"CLI serve <artifact>: {banner}; ready in {ready_s:.2f} s (warm cache); 2 requests "
          f"equal to this process's compiled artifact: bitwise {http_bitwise} (max abs diff "
          f"{http_err:.3e}); {COUNTERS} launches {sub_counts}", flush=True)
    return {"export_predictor": counts, "cli_serve_artifact": sub_counts}


def start_pool_export(tmp: str, params):
    """(c), first half: phase 10's CBFSSMHALF 'rnn' model with ``params``
    written as a trained directory, and ``python -m cbfssm_tpu_torch
    export DIR --kind pool --capacity 32 --horizons 10 --replay-buckets
    16`` started on it in a subprocess (on the card), after phase 6, so
    the pool's trace runs beside phases 7-10. Returns what
    :func:`export_pool` needs."""
    import os

    import torch

    from cbfssm_tpu_torch.models import CBFSSMHALF

    model = rnn_model(CBFSSMHALF, "float32", "pallas")
    if params is None:
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    half_dir, path = os.path.join(tmp, "half"), os.path.join(tmp, "pool")
    save_model_dir(half_dir, model, params)
    dev = [] if DEVICE == "cuda" else ["--device", DEVICE]
    log = open(os.path.join(tmp, "export_pool_log.txt"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cbfssm_tpu_torch", "export", half_dir, "--out", path,
         "--kind", "pool", "--capacity", str(FLEET), "--horizons", str(EXPORT_H),
         "--replay-buckets", str(EXPORT_REPLAY), *dev],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True)
    kill_at_exit(proc)
    return model, params, path, proc, log, time.perf_counter()


def export_pool(card: str, tmp: str, started) -> dict:
    """(c): the pool artifact that :func:`start_pool_export`'s CLI
    subprocess writes (capacity 32, horizon 10, replay bucket 16, phase
    10's CBFSSMHALF params); ``serve <artifact> --filter`` started in a
    subprocess while this process loads the artifact as an
    ``ExportedFilterPool``. Counted: 32 attaches, 64 ticks,
    a 10-step forecast and a ragged replay (lengths uniform in [1, 16],
    one padded chunk): 64 + 10 + 16 launches. Then a live ``FilterPool``
    runs the same and must equal it bitwise, and failover runs both ways
    (live -> artifact, artifact -> a seed-7 live standby), 3 ticks each,
    bitwise. The served pool answers an attach and a step, equal to a
    live pool's. Returns the launches by path."""
    import statistics

    import numpy as np

    from cbfssm_tpu_torch.export import gp_predict_nodes
    from cbfssm_tpu_torch.export_pool import ExportedFilterPool
    from cbfssm_tpu_torch.serving import FilterPool

    model, params, path, proc, log, t_start = started
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    export_s = time.perf_counter() - t_start
    log.seek(0)
    out = log.read()
    log.close()
    if rc != 0 or "exported filter_pool (CBFSSMHALF, best checkpoint)" not in out:
        fail(f"CLI export --kind pool: exit {rc}: {out[-2000:]}")
    u_all, y_all = served_windows()
    r, n = int(model.config.recog_len), FLEET

    ready, expected = threading.Event(), []

    def use(base):
        if not ready.wait(timeout=600):
            return None
        code, out = http_json("POST", base + "/v1/sessions", {
            "u_prefix": u_all[0, :r].tolist(), "y_prefix": y_all[0, :r].tolist()})
        code2, step = http_json("POST", f"{base}/v1/sessions/{out.get('sid')}/step",
                                {"u_prev": u_all[0, r - 1].tolist(), "y_new": y_all[0, r].tolist()})
        return code, code2, step

    join = background_serve(["serve", "--filter", path], tmp, "CLI serve --filter <artifact>",
                            use)
    t0 = time.perf_counter()
    epool = ExportedFilterPool(path, device=DEVICE)
    load_s = time.perf_counter() - t0
    nodes = {k: gp_predict_nodes(p) for k, p in epool.model.programs().items()}
    want_nodes = {"init": 0, "step": 1, f"forecast_{EXPORT_H}": EXPORT_H,
                  f"replay_{EXPORT_REPLAY}": EXPORT_REPLAY}
    if nodes != want_nodes:
        fail(f"export_pool: gp_predict nodes {nodes} != {want_nodes}")
    lengths = np.random.default_rng(0).integers(1, EXPORT_REPLAY + 1, size=n)
    t_fc, t_rep = r + FILTER_TICKS, r + FILTER_TICKS + EXPORT_H

    def scenario(pool, times):
        sids = [pool.attach(u_all[i, :r], y_all[i, :r]) for i in range(n)]
        ticks = [timed_call(times["tick"], pool.step,
                            {s: (u_all[i, r - 1 + k], y_all[i, r + k]) for i, s in enumerate(sids)})
                 for k in range(FILTER_TICKS)]
        fc = timed_call(times["forecast"], pool.forecast,
                        {s: u_all[i, t_fc:t_fc + EXPORT_H] for i, s in enumerate(sids)})
        rep = timed_call(times["replay"], pool.replay,
                         {s: (u_all[i, t_rep - 1:t_rep - 1 + lengths[i]],
                              y_all[i, t_rep:t_rep + lengths[i]]) for i, s in enumerate(sids)})
        return sids, ticks, fc, rep

    def tail_ticks(a, b, sids, k0):
        """3 more ticks of pools ``a`` and ``b``: equal?"""
        ok = True
        for k in range(k0, k0 + 3):
            inputs = {s: (u_all[i, r - 1 + k], y_all[i, r + k]) for i, s in enumerate(sids)}
            oa, ob = a.step(inputs), b.step(inputs)
            ok = ok and all(same_pair(oa[s], ob[s]) for s in sids)
        return ok

    times = {w: {k: [] for k in ("tick", "forecast", "replay")} for w in ("artifact", "live")}
    reset_launches()
    t0 = time.perf_counter()
    got = scenario(epool, times["artifact"])
    run_s = time.perf_counter() - t0
    counts = read_launches("export_pool", FILTER_TICKS + EXPORT_H + EXPORT_REPLAY,
                           f"{FILTER_TICKS} ticks + forecast H {EXPORT_H} + one replay chunk "
                           f"of {EXPORT_REPLAY}")
    live = FilterPool(model, params, capacity=n, replay_buckets=(EXPORT_REPLAY,))
    want = scenario(live, times["live"])
    sids = got[0]
    if got[0] != want[0]:
        fail("export_pool: session ids differ from the live pool's")
    for k, (a, b) in enumerate(zip(got[1], want[1])):
        for s in sids:
            check_moments(f"export_pool tick {k}", *a[s], (2,))
        if not all(same_pair(a[s], b[s]) for s in sids):
            fail(f"export_pool: tick {k} differs from the live pool's")
    for what, a, b in (("forecast", got[2], want[2]), ("replay", got[3], want[3])):
        if not all(same_pair(a[s], b[s]) for s in sids):
            fail(f"export_pool: the {what} differs from the live pool's")
    if not np.array_equal(epool.state[0], live.state[0]) or epool.state[1:4] != live.state[1:4]:
        fail("export_pool: the artifact pool's state differs from the live pool's")
    # failover: live -> artifact (after the live pool moved on alone) and
    # artifact -> a live standby of another seed
    k0 = FILTER_TICKS + EXPORT_H + EXPORT_REPLAY + 1
    live.step({s: (u_all[i, r - 1 + k0], y_all[i, r + k0]) for i, s in enumerate(sids)})
    epool.load_state(live.state)
    to_artifact = tail_ticks(live, epool, sids, k0 + 1)
    standby = FilterPool(model, params, capacity=n, seed=7, replay_buckets=(EXPORT_REPLAY,))
    standby.load_state(epool.state)
    to_live = tail_ticks(epool, standby, sids, k0 + 4)
    if not (to_artifact and to_live):
        fail(f"export_pool: failover live -> artifact {to_artifact}, artifact -> live {to_live}")
    # (c) the served pool: what a fresh live pool answers to its attach + step
    ref_pool = FilterPool(model, params, capacity=n)
    ref_sid = ref_pool.attach(u_all[0, :r], y_all[0, :r])
    expected.append(ref_pool.step({ref_sid: (u_all[0, r - 1], y_all[0, r])})[ref_sid])
    ready.set()
    banner, ready_s, result, sub_counts = join()
    if result is None or result[:2] != (200, 200):
        fail(f"CLI serve --filter <artifact>: {str(result)[:300]}")
    step = result[2]
    http_bitwise = all(np.array_equal(np.asarray(step[k], dtype=np.float32), expected[0][i])
                       for i, k in enumerate(("mean", "var")))
    http_err = max(float(np.abs(np.asarray(step[k]) - expected[0][i]).max())
                   for i, k in enumerate(("mean", "var")))
    if not all(np.allclose(step[k], expected[0][i], rtol=2e-5, atol=1e-6)
               for i, k in enumerate(("mean", "var"))):
        fail(f"CLI serve --filter <artifact>: the step differs from a live pool's by "
             f"{http_err:.3e}")
    if sub_counts != (1, 0, 0, 0):
        fail(f"CLI serve --filter <artifact>: {COUNTERS} launches {sub_counts} != (1, 0, 0, 0)")
    med = {w: {k: statistics.median(v) for k, v in t.items()} for w, t in times.items()}
    print(f"export_pool: `python -m cbfssm_tpu_torch export --kind pool` of the CBFSSMHALF "
          f"directory (capacity {n}, horizon {EXPORT_H}, replay bucket {EXPORT_REPLAY}) wrote "
          f"the artifact (a subprocess started after phase 6, joined {export_s:.2f} s after "
          f"its start), loaded here on the card in {load_s:.2f} s; gp_predict nodes {nodes}; {n} attaches, {FILTER_TICKS} ticks, "
          f"forecast, ragged replay (lengths {int(lengths.min())}-{int(lengths.max())}) in "
          f"{run_s:.2f} s, launches {counts[0]}; every output equal to a live FilterPool's "
          f"bitwise; failover live -> artifact and artifact -> a seed-7 live standby: 3 ticks "
          f"each, bitwise", flush=True)
    print(f"latency export_pool ({n} sessions, float32, host ms): artifact tick "
          f"{fmt_times(times['artifact']['tick'])}, forecast {med['artifact']['forecast']:.3f}, "
          f"replay {med['artifact']['replay']:.3f}; live tick "
          f"{fmt_times(times['live']['tick'])}, forecast {med['live']['forecast']:.3f}, replay "
          f"{med['live']['replay']:.3f}; {card}", flush=True)
    print(f"CLI serve --filter <artifact>: {banner}; ready in {ready_s:.2f} s; attach + step "
          f"equal to a live pool's: bitwise {http_bitwise} (max abs diff {http_err:.3e}); "
          f"{COUNTERS} launches {sub_counts}", flush=True)
    return {"export_pool": counts, "cli_serve_pool": sub_counts}


def bucket_cost_fit(card: str) -> dict:
    """(d) The cost of one ``BucketedPredictor`` dispatch against its
    rows: CBFSSM at the RoboMove width, float32, 'pallas', phase 4's
    params, B = 1, 2, 4, 8, 16, 32 (one warm-up each, then 15 rounds in
    alternating order), host ms to the numpy reply. The least-squares
    line ms = c0 + c1 * B gives the planner's cost (1, c1 / c0)."""
    import statistics

    import numpy as np
    import torch

    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.serving import BucketedPredictor

    model = CBFSSM(config("float32", "pallas"), device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    u_all, y_all = served_windows()
    bp = BucketedPredictor(model, params, SEQ_LEN, buckets=FIT_BUCKETS)
    times = {b: [] for b in FIT_BUCKETS}
    for b in FIT_BUCKETS:
        bp(u_all[:b], y_all[:b])
    for k in range(FIT_REPEATS):
        for b in (FIT_BUCKETS if k % 2 == 0 else FIT_BUCKETS[::-1]):
            t0 = time.perf_counter()
            bp(u_all[:b], y_all[:b])  # numpy replies: the device work is done
            times[b].append(1e3 * (time.perf_counter() - t0))
    med = {b: statistics.median(t) for b, t in times.items()}
    bs, ms = np.asarray(FIT_BUCKETS, float), np.asarray([med[b] for b in FIT_BUCKETS])
    c1, c0 = np.polyfit(bs, ms, 1)
    residual = ms - (c0 + c1 * bs)
    c1_se = float(np.sqrt(residual @ residual / (len(bs) - 2) / np.sum((bs - bs.mean()) ** 2)))
    cost = (1.0, float(c1 / c0))
    print(f"bucket cost fit: CBFSSM BucketedPredictor B={list(FIT_BUCKETS)} float32, median of "
          f"{FIT_REPEATS} host ms {', '.join(f'{b}: {m:.2f}' for b, m in med.items())}; "
          f"least squares ms = {c0:.4f} + {c1:.5f} (standard error {c1_se:.5f}) x B -> "
          f"MEASURED_COST (1.0, {cost[1]!r}); {card}", flush=True)
    return {"c0_ms": float(c0), "c1_ms": float(c1), "c1_se_ms": c1_se, "cost": cost,
            "median_ms": {str(b): m for b, m in med.items()}}


def op_host_cost(card: str) -> dict:
    """The host cost of the custom op ``cbfssm_torch::gp_predict`` (the
    exported programs' call) against the direct wrapper call (eager
    serving's): 2,000 back-to-back calls each at a B = 1 step's shape
    (N 50, M 100, DI 6, D 4, float32), two rounds in turns, host us per
    call ending in a device sync. Not a main path: uncounted."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.ops import fused_predict as fp
    from cbfssm_tpu_torch.utils.kernel_timing import kernel_inputs

    args = kernel_inputs(np.random.default_rng(11), 50, 100, 6, 4, torch.float32, DEVICE)
    calls = {"op": torch.ops.cbfssm_torch.gp_predict, "wrapper": fp._fused_predict_value}
    for fn in calls.values():
        fn(*args)
    sync()
    us = {k: [] for k in calls}
    for order in (("op", "wrapper"), ("wrapper", "op")):
        for k in order:
            t0 = time.perf_counter()
            for _ in range(OP_CALLS):
                calls[k](*args)
            sync()
            us[k].append(1e6 * (time.perf_counter() - t0) / OP_CALLS)
    out = {k: min(v) for k, v in us.items()}
    print(f"op host cost: {OP_CALLS} calls at N=50 M=100 DI=6 D=4 float32, host us per call "
          f"(best of 2 rounds; both rounds {us}): custom op {out['op']:.2f}, direct wrapper "
          f"{out['wrapper']:.2f}; {card}", flush=True)
    return out


def phase_export(card: str, half_params=None, cold=None, pool=None):
    """Phase 11: deployment artifacts at the RoboMove width (float32,
    ``gp_impl='pallas'``): the predictor compiled at load, exported and
    first loaded by ``cold`` (:func:`start_cold_compile`), and its
    ``serve`` subprocess (:func:`export_predictor`), the pool that
    ``pool``'s CLI subprocess exports (:func:`start_pool_export`, phase
    6's trained CBFSSMHALF ``half_params``) and its ``serve --filter``
    subprocess (:func:`export_pool`), the bucket-cost fit
    (:func:`bucket_cost_fit`) and the op's host cost
    (:func:`op_host_cost`). ``cold`` and ``pool`` are started here when
    None. Returns (launches by path, the fit, the host costs)."""
    import tempfile

    cold = cold or start_cold_compile(card)
    pool = pool or start_pool_export(build_tempdir(), half_params)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        paths = export_predictor(card, tmp, cold)
        paths.update(export_pool(card, tmp, pool))
    fit = bucket_cost_fit(card)
    host_us = op_host_cost(card)
    print(f"export: launches by path {paths}", flush=True)
    return paths, fit, host_us


# --- phase 12: process groups -------------------------------------------------

MESH_TRAIN, MESH_TEST = 64, 32  # phase 12's cut windows: 2 Adam steps, 1 test batch
MESH_LANE_TRAIN = 32  # its lane run: 1 step of each of 2 lanes, 1 test batch
MESH_SEED = 5  # the batch seed of the ParticleParallel loss


class _Windows:
    """A windowed dataset from its arrays (``train_in_batch``, ...)."""

    def __init__(self, **arrays):
        self.__dict__.update(arrays)


def mesh_arrays(ds, n_train: int) -> dict:
    return {"train_in_batch": ds.train_in_batch[:n_train],
            "train_out_batch": ds.train_out_batch[:n_train],
            "test_in_batch": ds.test_in_batch[:MESH_TEST],
            "test_out_batch": ds.test_out_batch[:MESH_TEST]}


def mesh_train(model, model_dir, ds, mesh, epochs: int = 1):
    """``Trainer(model, model_dir, seed=0, mesh=mesh).train(ds)`` with each
    ``train_step`` and each gradient reduction timed on the host clock
    (both ending in a device sync). Returns the trainer, the step ms and
    the gradient all-reduce ms."""
    from cbfssm_tpu_torch.training import Trainer

    trainer = Trainer(model, model_dir, seed=0, mesh=mesh)
    steps, reduces = [], []

    def timed(fn, times):
        def call(*args):
            sync()
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    trainer.train_step = timed(trainer.train_step, steps)
    trainer.dp.reduce_grads = timed(trainer.dp.reduce_grads, reduces)
    trainer.train(ds, epochs=epochs)
    del trainer.train_step, trainer.dp.reduce_grads
    return trainer, steps, reduces


def host_leaves(tensors) -> list:
    return [t.detach().cpu().numpy().copy() for t in tensors]


def first_batch(model, ds, batch: int):
    """(u, y) of the first ``batch`` training windows on the card."""
    import torch

    kw = dict(dtype=model.dtype, device=DEVICE)
    return (torch.as_tensor(ds.train_in_batch[:batch], **kw),
            torch.as_tensor(ds.train_out_batch[:batch], **kw))


def particle_serial(model_cls, cfg, params, u, y, n: int):
    """The serial emulation of a ParticleParallel loss on a particle mesh
    of ``n``: each shard's S / n particles drawn from its seed
    (``fold_seed(MESH_SEED, idx)``), one shard after the other, summed.
    Returns (loss, gradient leaves)."""
    import torch

    from cbfssm_tpu_torch.config import as_config
    from cbfssm_tpu_torch.streams import fold_seed

    cfg = as_config(cfg)
    local = model_cls(dataclasses.replace(cfg, samples=cfg.samples // n), device=DEVICE)
    leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
    total = 0.0
    for idx in range(n):
        gen = torch.Generator(device=DEVICE).manual_seed(fold_seed(MESH_SEED, idx))
        _, aux = local.loss(params.with_tensors(leaves), u, y, gen, True)
        total = total + aux["particle_sum"]
    loss = -(total / cfg.samples + aux["global_term"])
    return float(loss.detach()), host_leaves(torch.autograd.grad(loss, leaves))


def mesh_rank(rank: int, world: int, store: str, spec: dict, queue) -> None:
    """One rank of phase 12 (b), spawned: a gloo group of ``world`` ranks
    on the one card. Puts ``(rank, results, None)`` or ``(rank, None,
    traceback)`` on ``queue``."""
    global DEVICE
    import traceback

    DEVICE = spec["device"]
    from cbfssm_tpu_torch.parallel import distributed

    try:
        distributed.initialize(coordinator_address=f"file://{store}", num_processes=world,
                               process_id=rank, local_device_ids=0, backend="gloo")
        queue.put((rank, mesh_rank_paths(spec), None))
    except Exception:  # fail() exits the rank instead: the parent sees it die
        queue.put((rank, None, traceback.format_exc()))
    finally:
        distributed.shutdown()


def mesh_rank_paths(spec: dict) -> dict:
    """Phase 12 (b) on this rank: the meshed Trainer, the ParticleParallel
    loss and gradient, the seed-sharded lanes, each between
    ``reset_launches`` and ``launch_counts``, then the census of one
    meshed step and of one lane step (not counted)."""
    import torch

    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.parallel import DataParallel, ParticleParallel, census, make_mesh
    from cbfssm_tpu_torch.training import MultiSeedTrainer

    cfg = spec["config"]
    ds = _Windows(**spec["ds"])
    lane_ds = _Windows(**spec["lane_ds"])
    mesh = make_mesh(device=DEVICE)
    out = {}
    reset_launches()
    tr, steps, reduces = mesh_train(CBFSSM(cfg, device=DEVICE), spec["dir"], ds, mesh)
    out["dp"] = dict(counts=launch_counts(), train_all=tr.train_all, test_all=tr.test_all,
                     params=host_leaves(tr.params.tensors()), step_ms=steps, reduce_ms=reduces)
    u, y = first_batch(tr.model, ds, int(cfg["batch_size"]))
    w = torch.ones(u.shape[0], dtype=u.dtype, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(MESH_SEED)
    with census.record() as items:
        tr.train_step(u, y, w, gen, None)
    out["dp"].update(census=items, param_bytes=sum(p.numel() * p.element_size()
                                                   for p in tr.params.tensors()))

    pp = ParticleParallel(CBFSSM, cfg, make_mesh(axis_name="particle", device=DEVICE),
                          device=DEVICE)
    params = pp.init(torch.Generator(device=DEVICE).manual_seed(0))
    leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
    reset_launches()
    sync()
    t0 = time.perf_counter()
    loss, _ = pp.loss(params.with_tensors(leaves), u, y, MESH_SEED)
    grads = list(torch.autograd.grad(loss, leaves))
    DataParallel(pp.mesh).reduce_grads(grads)
    sync()
    out["particle"] = dict(counts=launch_counts(), loss=float(loss.detach()),
                           grads=host_leaves(grads),
                           ms=1e3 * (time.perf_counter() - t0))

    reset_launches()
    ms = MultiSeedTrainer(CBFSSM(cfg, device=DEVICE), spec["lane_dir"], n_seeds=2, mesh=mesh)
    ms.train(lane_ds, epochs=1)
    out["lanes"] = dict(counts=launch_counts(), train_all=ms.train_all, test_all=ms.test_all,
                        params=host_leaves(ms.params.tensors()))
    ms.init_state()
    data_u, data_y = ms._stage("train", lane_ds.train_in_batch, lane_ds.train_out_batch)
    b = int(cfg["batch_size"])
    idx, w = ms._epoch_indices(data_u.shape[0], b, shuffle=True)
    rows = torch.as_tensor(idx[:, 0].astype("int64"), device=DEVICE)
    noises = ms._noises(0, 0, 0, b, data_u.shape[1])
    with census.record() as items:
        ms.train_step(data_u[rows], data_y[rows], torch.as_tensor(w[:, 0], device=DEVICE),
                      noises)
    out["lanes"]["census"] = items
    return out


def spawn_ranks(world: int, spec: dict, store_dir: str, timeout: float = 600.0) -> list:
    """``mesh_rank`` in ``world`` spawned processes; their results in rank
    order. Fails if a rank fails, dies or outlasts ``timeout``; every
    process is joined or killed before it returns."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = f"{store_dir}/store"
    procs = [ctx.Process(target=mesh_rank, args=(r, world, store, spec, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            if time.monotonic() > deadline:
                errors[-1] = f"ranks outlasted {timeout} s"
                break
            try:
                rank, res, err = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                for r in dead:
                    errors[r] = f"died with exit code {procs[r].exitcode}"
                continue
            if err:
                errors[rank] = err
            else:
                results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        fail("phase 12: " + "; ".join(f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [results[r] for r in range(world)]


def close_leaves(got, want, rtol: float) -> float:
    """The largest error over the largest entry, leaf by leaf; fails
    unless every entry is within rtol, with atol rtol x the leaf's
    largest entry."""
    import numpy as np

    worst = 0.0
    for k, (a, b) in enumerate(zip(got, want, strict=True)):
        scale = float(np.abs(b).max()) if b.size else 0.0
        err = np.abs(a - b)
        if (err > rtol * np.abs(b) + rtol * scale).any():
            return float("inf")
        worst = max(worst, float(err.max()) / max(scale, 1e-300) if b.size else 0.0)
    return worst


def nccl_world_1(card: str, model_cfg: dict, ds):
    """Phase 12 (a): a one-rank NCCL group in this process: the cut
    epoch through ``Trainer(mesh=process_mesh((1,), ('data',)))``, its
    launches counted, bitwise against the meshless epoch. Returns the
    counts and the meshless run (the reference of (b))."""
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.parallel import distributed

    runs = {}
    with tempfile_dir() as tmp:
        flat = mesh_train(CBFSSM(model_cfg, device=DEVICE), f"{tmp}/flat", ds, None)
        distributed.initialize(coordinator_address=f"file://{tmp}/nccl_store", num_processes=1,
                               process_id=0, local_device_ids=0,
                               backend="nccl" if DEVICE == "cuda" else "gloo")
        try:
            mesh = distributed.process_mesh((1,), ("data",), device=DEVICE)
            reset_launches()
            meshed = mesh_train(CBFSSM(model_cfg, device=DEVICE), f"{tmp}/mesh", ds, mesh)
            counts = read_launches("dp_nccl_1", (STEPS_PER_CHUNK, 2 * STEPS_PER_CHUNK, 0, 0),
                                   f"2 steps x {STEPS_PER_CHUNK} residual, 1 test batch x "
                                   f"{STEPS_PER_CHUNK}")
        finally:
            distributed.shutdown()
    for name, (tr, steps, reduces) in (("flat", flat), ("mesh", meshed)):
        runs[name] = (tr.train_all, tr.test_all, host_leaves(tr.params.tensors()), steps,
                      reduces)
    if runs["mesh"][:2] != runs["flat"][:2]:
        fail(f"dp_nccl_1: losses {runs['mesh'][:2]} != meshless {runs['flat'][:2]}")
    if not all((a == b).all() for a, b in zip(runs["mesh"][2], runs["flat"][2], strict=True)):
        fail("dp_nccl_1: params after 2 steps differ from the meshless run's")
    print(f"process groups dp_nccl_1: NCCL world 1, 2 Adam steps of B={BATCH} float64 + 1 test "
          f"batch bitwise equal to the meshless run (train {runs['flat'][0]!r}, test "
          f"{runs['flat'][1]!r}); launches {counts}; step ms meshed {fmt_list(runs['mesh'][3])} "
          f"(meshless {fmt_list(runs['flat'][3])}), gradient all-reduce ms "
          f"{fmt_list(runs['mesh'][4])}; {card}", flush=True)
    return counts, runs["flat"]


def fmt_list(times) -> str:
    return "[" + ", ".join(f"{t:.2f}" for t in times) + "]"


@contextlib.contextmanager
def tempfile_dir():
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        yield tmp


def phase_mesh(card: str):
    """Phase 12: meshed training in process groups, float64 at the full
    RoboMove width. (a) NCCL world 1 in this process; (b) a gloo group of
    2 spawned ranks on the one card: the meshed Trainer, ParticleParallel
    and the seed-sharded lanes against this process's runs, launches
    held per rank, and the census. Returns the four paths' counts."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.parallel import census
    from cbfssm_tpu_torch.training import MultiSeedTrainer

    cfg = config("float64", "pallas")
    full = robomove()
    ds = _Windows(**mesh_arrays(full, MESH_TRAIN))
    lane_ds = _Windows(**mesh_arrays(full, MESH_LANE_TRAIN))
    nccl_counts, flat = nccl_world_1(card, cfg, ds)
    # this process's references for (b)
    model = CBFSSM(cfg, device=DEVICE)
    u, y = first_batch(model, ds, BATCH)
    pp_loss, pp_grads = particle_serial(CBFSSM, cfg, model.init(
        torch.Generator(device=DEVICE).manual_seed(0)), u, y, 2)
    with tempfile_dir() as tmp:
        ms = MultiSeedTrainer(model, tmp, n_seeds=2)
        ms.train(lane_ds, epochs=1)
        lanes = (ms.train_all, ms.test_all, host_leaves(ms.params.tensors()))
    with tempfile_dir() as tmp:
        spec = {"device": DEVICE, "config": cfg, "ds": mesh_arrays(full, MESH_TRAIN),
                "lane_ds": mesh_arrays(full, MESH_LANE_TRAIN), "dir": f"{tmp}/dp",
                "lane_dir": f"{tmp}/lanes"}
        t0 = time.perf_counter()
        ranks = spawn_ranks(2, spec, tmp)
        spawn_s = time.perf_counter() - t0
    rules = {"dp_gloo_2": ((STEPS_PER_CHUNK, 2 * STEPS_PER_CHUNK, 0, 0),
                           f"per rank: 2 steps x {STEPS_PER_CHUNK} residual, 1 test batch x "
                           f"{STEPS_PER_CHUNK}"),
             "particle_gloo_2": ((0, STEPS_PER_CHUNK, 0, 0),
                                 f"per rank: 1 loss and gradient x {STEPS_PER_CHUNK} residual"),
             "lanes_mesh_2": ((0, 0, STEPS_PER_CHUNK, STEPS_PER_CHUNK),
                              f"per rank: 1 lane step x {STEPS_PER_CHUNK} residual lanes, 1 "
                              f"test batch x {STEPS_PER_CHUNK} lanes")}
    keys = {"dp_gloo_2": "dp", "particle_gloo_2": "particle", "lanes_mesh_2": "lanes"}
    for path, (want, rule) in rules.items():
        for rank, out in enumerate(ranks):
            if out[keys[path]]["counts"] != want:
                fail(f"{path} rank {rank}: {COUNTERS} launches {out[keys[path]]['counts']} != "
                     f"{want} = {rule}")
    dp0, dp1 = ranks[0]["dp"], ranks[1]["dp"]
    for rank, out in enumerate(ranks):
        dp = out["dp"]
        if not (np.allclose(dp["train_all"], flat[0], rtol=1e-10, atol=0)
                and np.allclose(dp["test_all"], flat[1], rtol=1e-10, atol=0)):
            fail(f"dp_gloo_2 rank {rank}: losses {dp['train_all']} / {dp['test_all']} vs "
                 f"single-process {flat[0]} / {flat[1]} (rtol 1e-10)")
    dp_err = close_leaves(dp0["params"], flat[2], 1e-10)
    if dp_err == float("inf"):
        fail("dp_gloo_2: params after 2 steps vs the single-process run beyond rtol 1e-10")
    if not all((a == b).all() for a, b in zip(dp0["params"], dp1["params"], strict=True)):
        fail("dp_gloo_2: the two ranks' params differ")
    pp_err = 0.0
    for rank, out in enumerate(ranks):
        pp = out["particle"]
        if abs(pp["loss"] - pp_loss) > 1e-10 * abs(pp_loss):
            fail(f"particle_gloo_2 rank {rank}: loss {pp['loss']!r} vs serial {pp_loss!r}")
        err = close_leaves(pp["grads"], pp_grads, 1e-10)
        if err == float("inf"):
            fail(f"particle_gloo_2 rank {rank}: gradient beyond rtol 1e-10 of the serial one")
        pp_err = max(pp_err, err)
    lane_err = 0.0
    for rank, out in enumerate(ranks):
        ln = out["lanes"]
        if not (np.allclose(np.stack(ln["train_all"]), np.stack(lanes[0]), rtol=1e-10, atol=0)
                and np.allclose(np.stack(ln["test_all"]), np.stack(lanes[1]), rtol=1e-10,
                                atol=0)):
            fail(f"lanes_mesh_2 rank {rank}: lane losses {ln['train_all']} / {ln['test_all']} "
                 f"vs unsharded {lanes[0]} / {lanes[1]} (rtol 1e-10)")
        err = close_leaves(ln["params"], lanes[2], 1e-10)
        if err == float("inf"):
            fail(f"lanes_mesh_2 rank {rank}: params beyond rtol 1e-10 of the unsharded lanes")
        lane_err = max(lane_err, err)
    for rank, out in enumerate(ranks):
        items = out["dp"]["census"]
        census.assert_data_parallel_contract(items, out["dp"]["param_bytes"],
                                             context=f"dp_gloo_2 rank {rank} step")
        grads = [c for c in items if c.result_bytes == out["dp"]["param_bytes"]]
        if len(grads) != 1 or len(items) != 2:
            fail(f"dp_gloo_2 rank {rank}: census {census.describe(items)} is not one gradient "
                 "all-reduce and one scalar all-reduce")
        if out["lanes"]["census"]:
            fail(f"lanes_mesh_2 rank {rank}: a lane step ran "
                 f"{census.describe(out['lanes']['census'])}")
    for rank, out in enumerate(ranks):
        dp = out["dp"]
        print(f"process groups dp_gloo_2 rank {rank}: gloo world 2 on one card, 2 Adam steps "
              f"of {BATCH // 2} rows + 1 test batch, float64; losses {dp['train_all']!r} / "
              f"{dp['test_all']!r} within rtol 1e-10 of the single-process run; step ms "
              f"{fmt_list(dp['step_ms'])}, gradient all-reduce ms {fmt_list(dp['reduce_ms'])} "
              f"({dp['param_bytes']} B); launches {dp['counts']}; {card}", flush=True)
        print(f"  census of one meshed step: {census.describe(dp['census'])}", flush=True)
        pp = out["particle"]
        print(f"process groups particle_gloo_2 rank {rank}: S {cfg['samples'] // 2} a rank, loss "
              f"{pp['loss']!r} "
              f"vs serial {pp_loss!r}, loss + gradient + reduction {pp['ms']:.2f} ms; launches "
              f"{pp['counts']}; {card}", flush=True)
        print(f"process groups lanes_mesh_2 rank {rank}: 1 lane a rank, lane losses "
              f"{[a.tolist() for a in out['lanes']['train_all']]}; launches "
              f"{out['lanes']['counts']}; lane step census: "
              f"{census.describe(out['lanes']['census'])}; {card}", flush=True)
    print(f"process groups: 2 gloo ranks spawned, run and joined in {spawn_s:.2f} s; params "
          f"after 2 steps within {dp_err:.3e} (largest error / largest entry) of the "
          f"single-process run and bitwise equal across ranks; ParticleParallel gradient within "
          f"{pp_err:.3e} of the serial emulation; lane params within {lane_err:.3e}", flush=True)
    return {"dp_nccl_1": nccl_counts, "dp_gloo_2": ranks[0]["dp"]["counts"],
            "particle_gloo_2": ranks[0]["particle"]["counts"],
            "lanes_mesh_2": ranks[0]["lanes"]["counts"]}


MESH_POOL, MESH_TICKS, MESH_HELD = 1024, 8, 7  # phase 13 (a): capacity, ticks, held slot
MESH_REPLAY_MAX = 64  # the longest backlog of its ragged replay (one chunk of the (16, 64) ladder)
EPD_EPOCHS, EPD_LANE_EPOCHS = 5, 3  # (b): epochs at epd 1 and 2 (two blocks + a tail)


def pool_scenario_mesh(pool, ticks, fc_inputs, backlog):
    """(a)'s history on one pool: ``MESH_TICKS`` ticks, a forecast, a
    ragged replay, all under the collective census. Returns the outputs
    with the state, the tick ms, the launch counts and the census
    records."""
    from cbfssm_tpu_torch.parallel import census

    reset_launches()
    outs, tick_ms = {"ticks": []}, []
    with census.record() as items:
        for inputs in ticks:
            t0 = time.perf_counter()
            outs["ticks"].append(pool.step(inputs))
            tick_ms.append(1e3 * (time.perf_counter() - t0))
        outs["forecast"] = pool.forecast(fc_inputs)
        outs["replay"] = pool.replay(backlog)
    counts = launch_counts()
    outs["state"] = pool.state
    return outs, tick_ms, counts, items


def same_outputs(got: dict, want: dict) -> bool:
    """Every tick, forecast and replay output and the state bitwise."""
    import numpy as np

    for g, w in zip(got["ticks"], want["ticks"], strict=True):
        if set(g) != set(w) or not all(same_pair(g[s], w[s]) for s in w):
            return False
    for op in ("forecast", "replay"):
        if set(got[op]) != set(want[op]) or not all(same_pair(got[op][s], want[op][s])
                                                    for s in want[op]):
            return False
    gx, gt, gslots, gnext, gkey = got["state"]
    wx, wt, wslots, wnext, wkey = want["state"]
    return (np.array_equal(gx, wx) and (gt, gslots, gnext) == (wt, wslots, wnext)
            and np.array_equal(gkey, wkey))


def pool_mesh(card: str, params=None) -> dict:
    """(a) ``FilterPool(mesh=local_mesh(...))`` at the fleet's width
    (CBFSSMHALF 'rnn', RoboMove phase 0, float32, 'pallas', capacity
    1,024: N = 51,200 rows a tick unsharded): 32 attached sessions tiled
    to 1,024 load into the unsharded pool, whose state loads into pools
    over ``local_mesh(["cuda:0"])``, ``(["cuda:0"] * 2)`` and every
    visible card; each runs 8 ticks with one session held, a forecast of
    all sessions at H 50 and a ragged replay of 1..64 steps, bitwise
    equal to the unsharded pool, with blocks x its launches and no
    collective. Returns the paths' launch counts."""
    import numpy as np
    import torch

    from cbfssm_tpu_torch.models import CBFSSMHALF
    from cbfssm_tpu_torch.parallel import local_mesh
    from cbfssm_tpu_torch.serving import FilterPool

    model = rnn_model(CBFSSMHALF, "float32", "pallas")
    if params is None:
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    u_all, y_all = served_windows()
    n, r = len(u_all), int(model.config.recog_len)
    seed_pool = FilterPool(model, params, capacity=FLEET)
    for i in range(FLEET):
        seed_pool.attach(u_all[i % n, :r], y_all[i % n, :r])
    x32, tick, _, _, key = seed_pool.state
    snapshot = (np.tile(x32, (MESH_POOL // FLEET, 1, 1)), tick,
                {i: i for i in range(MESH_POOL)}, MESH_POOL, key)
    ticks = [{i: (u_all[i % n, r - 1 + k], y_all[i % n, r + k]) for i in range(MESH_POOL)
              if i != MESH_HELD} for k in range(MESH_TICKS)]
    fc_inputs = {i: u_all[i % n, r + 20:r + 20 + FORECAST_H] for i in range(MESH_POOL)}
    backlog = {i: (u_all[i % n, r + 20:r + 20 + k], y_all[i % n, r + 21:r + 21 + k])
               for i, k in ((i, 1 + (37 * i // 2) % MESH_REPLAY_MAX)
                            for i in range(0, MESH_POOL, 2))}
    if max(len(u) for u, _ in backlog.values()) != MESH_REPLAY_MAX:
        fail("pool_mesh: the ragged backlog does not reach its longest length")
    card0 = "cuda:0" if DEVICE == "cuda" else DEVICE
    meshes = {"pool_unsharded": None, "pool_mesh_1": local_mesh([card0]),
              "pool_mesh_2": local_mesh([card0, card0])}
    if DEVICE == "cuda" and torch.cuda.device_count() > 1:
        meshes[f"pool_mesh_{torch.cuda.device_count()}gpu"] = local_mesh(
            [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    per_pool = MESH_TICKS + FORECAST_H + MESH_REPLAY_MAX  # launches of the unsharded pool
    paths, want, lines = {}, None, []
    unsharded = FilterPool(model, params, capacity=MESH_POOL, replay_buckets=REPLAY_BUCKETS)
    unsharded.load_state(snapshot)
    state = unsharded.state
    for name, mesh in meshes.items():
        t0 = time.perf_counter()
        if mesh is None:
            pool = unsharded
        else:  # cross-topology failover: the unsharded pool's state into the meshed one
            pool = FilterPool(model, params, capacity=MESH_POOL, mesh=mesh,
                              replay_buckets=REPLAY_BUCKETS)
            pool.load_state(state)
        outs, tick_ms, counts, items = pool_scenario_mesh(pool, ticks, fc_inputs, backlog)
        blocks = 1 if mesh is None else mesh.size
        rule = (f"{blocks} block(s) x ({MESH_TICKS} ticks + {FORECAST_H} forecast steps + "
                f"{MESH_REPLAY_MAX} replay steps)")
        if counts != (blocks * per_pool, 0, 0, 0):
            fail(f"{name}: {COUNTERS} launches {counts} != {(blocks * per_pool, 0, 0, 0)} = "
                 f"{rule}")
        if items:
            fail(f"{name}: the pool performed collectives: {items}")
        for k, out in enumerate(outs["ticks"]):
            mean = np.stack([out[s][0] for s in sorted(out)])
            var = np.stack([out[s][1] for s in sorted(out)])
            check_moments(f"{name} tick {k}", mean, var, (MESH_POOL - 1, 2))
        if want is None:
            want = outs
        elif not same_outputs(outs, want):
            fail(f"{name}: outputs or state differ from the unsharded pool's (bitwise)")
        paths[name] = counts
        lines.append(f"pool_mesh {name}: {blocks} block(s) of {MESH_POOL // blocks} sessions "
                     f"({MESH_POOL // blocks * model.samples} rows); tick ms "
                     f"{fmt_times(tick_ms)}; launches {counts}; no collective; "
                     f"{time.perf_counter() - t0:.2f} s; {card}")
    for line in lines:
        print(line, flush=True)
    print(f"pool_mesh: {len(meshes) - 1} meshed pools loaded from the unsharded pool's state, "
          f"{MESH_TICKS} ticks (slot {MESH_HELD} held), a forecast at H {FORECAST_H} and a "
          f"ragged replay of 1..{MESH_REPLAY_MAX} steps bitwise equal to it", flush=True)
    return paths


@contextlib.contextmanager
def strict_blocks(cls):
    """``torch.cuda.set_sync_debug_mode('error')`` while ``cls``'s
    ``_dispatch_block`` runs: a host sync inside a block raises."""
    import torch

    dispatch = cls._dispatch_block
    issued = []

    def strict(self, *args):
        if DEVICE != "cuda":
            issued.append(args)
            return dispatch(self, *args)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dispatch(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        issued.append(args)
        return out

    cls._dispatch_block = strict
    try:
        yield issued
    finally:
        cls._dispatch_block = dispatch


def same_checkpoints(dir_a: str, dir_b: str, names) -> bool:
    import os

    import torch

    from cbfssm_tpu_torch.training import checkpoint

    for name in names:
        a, b = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if os.path.exists(a) != os.path.exists(b):
            return False
        if os.path.exists(a):
            fa, sa = torch.utils._pytree.tree_flatten(checkpoint.restore(a))
            fb, sb = torch.utils._pytree.tree_flatten(checkpoint.restore(b))
            if sa != sb or not all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                                   for x, y in zip(fa, fb)):
                return False
    return True


def blocked_training(card: str) -> dict:
    """(b) Fused multi-epoch dispatch: CBFSSM float32 'pallas' at the
    RoboMove width on phase 12's cut windows (2 Adam steps of 32, 1 test
    batch an epoch), 5 epochs at ``epochs_per_dispatch`` 1 and 2 (two
    blocks and a tail), then a 2-lane ``MultiSeedTrainer`` for 3 epochs at
    1 and 2; every block under ``set_sync_debug_mode('error')``. Losses,
    best and last checkpoints bitwise equal, launches equal. Returns the
    four paths' counts."""
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.training import MultiSeedTrainer, Trainer, checkpoint
    from cbfssm_tpu_torch.training import multiseed

    ds = _Windows(**mesh_arrays(robomove(), MESH_TRAIN))
    model = CBFSSM(config("float32", "pallas"), device=DEVICE)
    steps = MESH_TRAIN // BATCH
    runs, paths = {}, {}

    def trainer(cls, path, epd):
        if cls is Trainer:
            return Trainer(model, path, seed=0, epochs_per_dispatch=epd)
        return MultiSeedTrainer(model, path, n_seeds=2, seed=0, epochs_per_dispatch=epd)

    with tempfile_dir() as tmp:
        for kind, cls, epochs in (("train", Trainer, EPD_EPOCHS),
                                  ("lanes", MultiSeedTrainer, EPD_LANE_EPOCHS)):
            # a 1-epoch run first, so that neither timed run pays the
            # path's first-call costs
            trainer(cls, f"{tmp}/{kind}_warm", 1).train(ds, epochs=1)
            for epd in (1, 2):
                path = f"{tmp}/{kind}_epd{epd}"
                tr = trainer(cls, path, epd)
                reset_launches()
                t0 = time.perf_counter()
                try:
                    with strict_blocks(cls) as issued:
                        tr.train(ds, epochs=epochs)
                except RuntimeError as exc:  # the sync debug mode's error
                    fail(f"{kind}_epd{epd}: a host sync inside a block: {exc}")
                run_s = time.perf_counter() - t0
                name = f"{kind}_epd{epd}"
                paths[name] = launch_counts()
                want_blocks = (epochs // 2) if epd == 2 else 0
                if len(issued) != want_blocks:
                    fail(f"{name}: {len(issued)} blocks issued, want {want_blocks}")
                runs[name] = (tr, path, run_s)
            (a, dir_a, s_a), (b, dir_b, s_b) = runs[f"{kind}_epd1"], runs[f"{kind}_epd2"]
            names = (checkpoint.BEST, checkpoint.LAST) + (
                (multiseed.BEST_SEEDS, multiseed.LAST_SEEDS) if cls is MultiSeedTrainer else ())
            if kind == "train":
                same = a.train_all == b.train_all and a.test_all == b.test_all
                per = (STEPS_PER_CHUNK, steps * STEPS_PER_CHUNK, 0, 0)
            else:
                import numpy as np

                same = (np.array_equal(np.stack(a.train_all), np.stack(b.train_all))
                        and np.array_equal(np.stack(a.test_all), np.stack(b.test_all)))
                per = (0, 0, STEPS_PER_CHUNK, steps * STEPS_PER_CHUNK)
            if not same:
                fail(f"{kind}: losses at epd 2 {b.train_all} / {b.test_all} != epd 1 "
                     f"{a.train_all} / {a.test_all}")
            if not same_checkpoints(dir_a, dir_b, names):
                fail(f"{kind}: the checkpoints at epd 2 differ from epd 1's")
            want = tuple(epochs * c for c in per)
            for epd in (1, 2):
                if paths[f"{kind}_epd{epd}"] != want:
                    fail(f"{kind}_epd{epd}: {COUNTERS} launches {paths[f'{kind}_epd{epd}']} != "
                         f"{want} = {epochs} epochs x ({steps} steps x {STEPS_PER_CHUNK} "
                         f"residual, 1 test batch x {STEPS_PER_CHUNK})")
            print(f"blocked {kind}: {epochs} epochs of {steps} Adam steps + 1 test batch "
                  f"(float32, {'1 model' if kind == 'train' else '2 lanes'}): epd 2 ({epochs // 2}"
                  f" block(s) + tail, no host sync inside a block) bitwise equal to epd 1 in "
                  f"losses and {', '.join(names)}; epoch ms (after a warm-up run) epd 1 "
                  f"{1e3 * s_a / epochs:.1f}, epd 2 {1e3 * s_b / epochs:.1f}; launches "
                  f"{paths[f'{kind}_epd2']} each; "
                  f"{card}", flush=True)
    return paths


def native_loader(card: str) -> None:
    """(c) The native host loader: the library loads on the card's host,
    ``window_gather`` on the float64 RoboMove series equals the numpy
    gather bitwise, and ``unwrap_euler_angles`` through it equals its
    Python loop bitwise; each pair timed."""
    import numpy as np

    from cbfssm_tpu_torch import native
    from cbfssm_tpu_torch.data import RoboMove, voliro_loader

    if not native.available():
        fail(f"native: the host loader did not build or load ({native.library_path()})")
    ds = RoboMove(SEQ_LEN, SEQ_STRIDE)
    x = np.ascontiguousarray(ds.train_in, dtype=np.float64)
    starts = np.arange(0, x.shape[1] - SEQ_LEN + 1, SEQ_STRIDE)
    if (x.shape[1] - SEQ_LEN) % SEQ_STRIDE:
        starts = np.append(starts, x.shape[1] - SEQ_LEN)
    times = {}
    for name, fn in (("native", lambda: native.window_gather(x, starts, SEQ_LEN)),
                     ("numpy", lambda: x[:, starts[:, None] + np.arange(SEQ_LEN)[None, :], :]
                      .reshape(-1, SEQ_LEN, x.shape[2]))):
        fn()
        t0 = time.perf_counter()
        for _ in range(20):
            out = fn()
        times[name] = (1e3 * (time.perf_counter() - t0) / 20, out)
    if not np.array_equal(times["native"][1], times["numpy"][1]):
        fail("native: window_gather differs from the numpy gather")
    if not np.array_equal(times["native"][1], ds.train_in_batch):
        fail("native: window_gather differs from the dataset's windows")
    print(f"native: {native.library_path().name} loaded; window_gather of the RoboMove train "
          f"series {x.shape} into {times['native'][1].shape} windows bitwise equal to numpy; "
          f"host ms native {times['native'][0]:.3f}, numpy {times['numpy'][0]:.3f} (mean of 20)",
          flush=True)
    # unwrap_euler_angles: the library against its Python loop (the
    # fallback), on a seeded wrapped random walk of 20,000 x 3 angles
    rng = np.random.default_rng(0)
    vec = np.cumsum(rng.normal(0.0, 0.3, (20000, 3)), axis=0)
    vec = (vec + np.pi) % (2 * np.pi) - np.pi
    loop_fn = native.unwrap_angles
    for name in ("native", "loop"):
        native.unwrap_angles = loop_fn if name == "native" else (lambda *args: None)
        try:
            voliro_loader.unwrap_euler_angles(vec)
            t0 = time.perf_counter()
            for _ in range(5):
                out = voliro_loader.unwrap_euler_angles(vec)
            times[name] = (1e3 * (time.perf_counter() - t0) / 5, out)
        finally:
            native.unwrap_angles = loop_fn
    if not np.array_equal(times["native"][1], times["loop"][1]):
        fail("native: unwrap_angles differs from the Python loop")
    print(f"native: unwrap_euler_angles of {vec.shape} angles bitwise equal to its Python loop; "
          f"host ms native {times['native'][0]:.3f}, loop {times['loop'][0]:.3f} (mean of 5)",
          flush=True)


def phase_last_modules(card: str, half_params=None) -> dict:
    """Phase 13: the meshed pool (a), fused multi-epoch dispatch (b) and
    the native host loader (c). Returns the launches by path."""
    t0 = time.perf_counter()
    paths = pool_mesh(card, half_params)
    paths.update(blocked_training(card))
    native_loader(card)
    print(f"last modules: launches by path {paths}; {time.perf_counter() - t0:.2f} s",
          flush=True)
    return paths


BENCH_NOISE_SEED = 11  # phase 14: the CPU generator of the step's noise


def phase_bench(card: str) -> None:
    """Phase 14: the bench's step on the card against the CPU, a short
    ``bench.measure`` and the result line's ``device``."""
    import io

    import numpy as np
    import torch

    from cbfssm_tpu_torch import bench
    from cbfssm_tpu_torch.models.voliro import VoliroNoise

    reset_launches()
    model, params, u, y = bench.build_voliro_parts(device=DEVICE)
    cpu_model, cpu_params, _, _ = bench.build_voliro_parts(device="cpu",
                                                           params=params.to("cpu"))
    noise = cpu_model.draw_noise(torch.Generator().manual_seed(BENCH_NOISE_SEED),
                                 bench.SEQ_LEN, bench.BATCH)
    card_noise = VoliroNoise(*(getattr(noise, f.name).to(DEVICE)
                               for f in dataclasses.fields(noise)))
    loss, grads = bench.Step(model, params, u, y, bench.LEARNING_RATE)(noise=card_noise)
    want_loss, want = bench.Step(cpu_model, cpu_params, u, y, bench.LEARNING_RATE)(noise=noise)
    loss = loss.item()
    loss_ratio = abs(loss - want_loss.item()) / (1e-5 * abs(want_loss.item()))
    grad_ratios = [float((g.cpu() - w).abs().max() / (1e-3 * w.abs().max().clamp_min(1e-30)))
                   for g, w in zip(grads, want)]
    print(f"bench: one float32 step on the card against the CPU: loss {loss!r} against "
          f"{want_loss.item()!r} ({loss_ratio:.3f} of rtol 1e-5); gradient leaves' max |a - b| "
          f"over 1e-3 max |b|: {', '.join(f'{r:.4f}' for r in grad_ratios)}", flush=True)
    if not np.isfinite(loss) or loss_ratio > 1.0 or max(grad_ratios) > 1.0:
        fail(f"bench: the card's step differs from the CPU's (loss {loss_ratio:.3f}, "
             f"gradients {max(grad_ratios):.4f} of their bounds)")
    t0 = time.perf_counter()
    rate = bench.measure(steps=3, warmup=2, device=DEVICE)
    if not (np.isfinite(rate) and rate > 0):
        fail(f"bench: measure(steps=3, warmup=2) gave {rate!r} steps/sec")
    print(f"bench: measure(steps=3, warmup=2) {rate:.4f} steps/sec in "
          f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        payload = bench._emit_json({"value": round(rate, 3), "device": bench.device_info()})
    if json.loads(out.getvalue()) != payload or not payload["device"].get("name"):
        fail(f"bench: the result line {out.getvalue().strip()} carries no device")
    print(f"bench: the result line carries device {payload['device']}", flush=True)
    read_launches("bench", (0, 0, 0, 0), "gp_impl='solve_free' launches none of the kernels")


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
    serving = timed("4 serving", phase_serving, card)
    cold = start_cold_compile(card)  # phase 11's export and cold compile, beside phases 5-10
    training, training_paths = timed("5 training", phase_training, card)
    other, half_params = timed("6 CBFSSMHALF and PRSSM", phase_other_models, card)
    pool = start_pool_export(build_tempdir(), half_params)  # phase 11 (c)'s, beside 7-10
    model_kernels, new_paths = timed("7 Voliro and Sarcos", phase_voliro_sarcos, card)
    lane_kernels, lane_paths = timed("8 lanes", phase_lanes, card)
    cli_paths = timed("9 CLI and HTTP", phase_cli_http, card)
    filter_kernels, filter_paths = timed("10 online filtering", phase_filters, card,
                                         half_params)
    export_paths, cost_fit, op_host_us = timed("11 export", phase_export, card, half_params,
                                               cold, pool)
    mesh_paths = timed("12 process groups", phase_mesh, card)
    last_paths = timed("13 last modules", phase_last_modules, card, half_params)
    timed("14 bench", phase_bench, card)
    print(f"all phases: {time.perf_counter() - t_start:.2f} s", flush=True)
    if "jax" in sys.modules:
        fail("jax was imported")
    # the four launch counts (COUNTERS) of every main path, as measured
    paths = {"serving": serving, "training": training, **training_paths, **other, **new_paths,
             **lane_paths, **cli_paths, **filter_paths, **export_paths, **mesh_paths,
             **last_paths}
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
    # the value kernel at the online-filter shapes of phase 10
    fleet = filter_kernels["fleet 1024"]
    kernels[0].update({
        "ms_n51200": fleet["ms"], "bound_ms_n51200": fleet["bound_ms"],
        "bound_by_n51200": fleet["bound_by"], "shape_n51200": f"float32 {fleet['shape']}",
        "filter_shapes": filter_kernels,
        "op_host_us": op_host_us,
        "bucket_cost_fit": cost_fit,
    })
    # the lane kernels: figures at the Sarcos recognition shape of phase 8
    lanes, ln, lm, ldi, ld = LANE_SHAPES["sarcos recognition"]
    for k, name in enumerate(("gp_predict_lanes", "gp_predict_residuals_lanes"), start=2):
        by_path = {path: counts[k] for path, counts in paths.items()
                   if counts[k] or path in SOLVE_FREE_PATHS}
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
