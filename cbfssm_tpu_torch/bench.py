"""Headline benchmark of the port: Voliro ELBO optimizer steps a second on
the card (port of the repository's ``bench.py``, with its own copies of
what that script takes from ``scripts/profile_mfu.py`` and
``scripts/bench_blocked_epochs.py``).

    python -m cbfssm_tpu_torch bench          # or python -m cbfssm_tpu_torch.bench

It measures full training steps (``Voliro.loss``, its gradient, and the
Trainer's Adam update, :func:`~cbfssm_tpu_torch.training.trainer.adam_update`,
lr 0.01) at run_voliro.py's widths (batch 16, seq 64, 20 particles, 20
inducing points, float32, ``gp_impl='solve_free'``) on synthetic inputs,
on the card, then prints ONE JSON line. The port's chunk is ``steps``
eagerly issued steps with one readback (the last loss, ``.item()``);
JAX's is one scanned program. The headline is the median of 3 timed
30-step chunks after ``max(2, warmup)`` warm ones; each chunk draws its
noise from a ``torch.Generator`` on the card seeded with the chunk's
index, as the JAX bench folds its key per chunk.

Keys of the line:

- ``value`` (``unit`` steps/sec): the headline;
- ``vs_baseline``: ``value`` over the same step on this host's CPU,
  measured once by a child process of this module
  (``CBFSSM_BENCH_CPU_CHILD=1``, no visible card, ``device='cpu'``, 5-step
  chunks) and cached with the CPU's name and torch's thread count in
  ``build/cbfssm_tpu_torch/bench_cpu_baseline.json``; ``null`` when the
  child failed, with the reason in ``baseline_error``;
- ``analytic_gflop_per_step`` and ``mfu_vs_f32_peak``: the step's GP-link
  matmul GFLOPs (logical, x3 for reverse mode) and GFLOPs x steps/sec
  over the card's float32 CUDA-core peak
  (:data:`~cbfssm_tpu_torch.utils.kernel_timing.PEAK_FLOPS`);
- ``shapes``: steps/sec, GFLOPs and MFU of the three CBFSSM shapes
  (robomove, sarcos, smallscale; 10-step chunks), an ``error`` per shape
  that failed;
- ``steps_per_sec_300_per_dispatch``: the headline step in 300-step
  chunks;
- ``trainer_blocked_steps_per_sec``: ``Trainer.train`` end to end at the
  headline shape (480 train / 16 test windows, 100 epochs,
  ``epochs_per_dispatch='auto'``), the steady tail after 10 epochs;
- ``multiseed_5x_s_per_epoch``: seconds an epoch of a 5-seed
  ``MultiSeedTrainer`` on the Spring data (run_spring.py's config, 30
  epochs), the steady tail after 10;
- ``device``: the card's ``name`` and ``power_limit`` as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` gives them;
- ``stage_seconds``: the wall time of each stage;
- on an abort (watchdog, SIGTERM / SIGINT, a stage that raises):
  ``error`` (500 characters at most) and ``stage``, beside everything
  measured before it.

``CBFSSM_BENCH_HEADLINE_ONLY=1`` runs the headline and the baseline
alone, ``CBFSSM_BENCH_NO_WATCHDOG=1`` starts no watchdog, and
``CBFSSM_BENCH_TOTAL_TIMEOUT`` sets its budget in seconds. Every stage
function takes the JAX bench's counts as its defaults, so a stage runs
alone as ``bench.measure_trainer()`` and so on.
"""

from __future__ import annotations

import contextlib
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from cbfssm_tpu_torch.ops._build import BUILD_DIR
from cbfssm_tpu_torch.training.trainer import adam_update
from cbfssm_tpu_torch.utils.kernel_timing import PEAK_FLOPS

BASELINE_CACHE = BUILD_DIR / "bench_cpu_baseline.json"
# the CPU baseline's child: this module, run as a script
CPU_CHILD = ("-m", "cbfssm_tpu_torch.bench")
PACKAGE_PARENT = Path(__file__).resolve().parents[1]

BATCH = 16
SEQ_LEN = 64
SAMPLES = 20
STEPS = 30
WARMUP = 3
LEARNING_RATE = 0.01

# the CBFSSM shapes of the reference drivers (run/*.py hyperparameters)
SHAPES = {
    # run_robomove.py: the compute-bound reference workload
    "robomove": dict(batch=32, seq_len=300, samples=50, m=100, dim_x=4,
                     dim_u=2, dim_y=2, recog_len=50, lr=0.01),
    # run_sarcos.py: the heaviest reference configuration
    "sarcos": dict(batch=5, seq_len=250, samples=20, m=100, dim_x=14,
                   dim_u=7, dim_y=7, recog_len=16, lr=0.05),
    # run_smallscale.py
    "smallscale": dict(batch=10, seq_len=50, samples=50, m=20, dim_x=4,
                       dim_u=1, dim_y=1, recog_len=16, lr=0.1),
}

WARM_EPOCHS = 10  # the loops' warm-up epochs, left out of their steady tail
N_TRAIN_WINDOWS = 480  # 30 batches of 16: the headline's 30 steps an epoch
N_TEST_WINDOWS = 16


# --- the headline step ---------------------------------------------------


def voliro_config(adjoint: str = "auto") -> dict:
    """The headline config (run_voliro.py's hyperparameters at the bench's
    batch and particles, float32, the default ``gp_impl``)."""

    class _DS:
        dim_u = 13
        dim_y = 22

    return {
        "ds": _DS,
        "batch_size": BATCH,
        "shuffle": 10000,
        "ind_pnt_num": 20,
        "samples": SAMPLES,
        "learning_rate": LEARNING_RATE,
        "loglik_factor": np.asarray([20.0, 0.0, 0.2 * 20 * 50]),
        "n_beta": [10.0, 2.0, 10.0],
        "l_beta": [1.0, 10.0, 10.0],
        "zeta_pos": 2.0,
        "zeta_mean": 0.05**2,
        "zeta_var": 0.01**2,
        "gp_var": 0.5**2,
        "gp_len": 5.0,
        "var_x": np.asarray([0.02] * 7 + [0.2] * 6) ** 2,
        "var_y": np.asarray([0.02] * 7 + [0.2] * 6) ** 2,
        "var_z": np.asarray([0.02] * 6),
        "dtype": "float32",
        "adjoint": adjoint,
    }


def build_voliro_parts(adjoint: str = "auto", device="cuda", params=None):
    """(model, params, u, y): the headline ``Voliro`` on ``device``, its
    params (``params``, or ``model.init`` from seed 0) and the synthetic
    batch, drawn from ``np.random.default_rng(0)`` in the JAX bench's
    order (the same arrays)."""
    from cbfssm_tpu_torch.models import Voliro

    model = Voliro(voliro_config(adjoint), device=device)
    if params is None:
        params = model.init(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    pwm = rng.uniform(0.3, 0.9, size=(BATCH, SEQ_LEN, 6))
    tilt = rng.uniform(-0.5, 0.5, size=(BATCH, SEQ_LEN, 6))
    ts = np.broadcast_to(
        np.arange(SEQ_LEN, dtype=np.float64)[None, :, None] * 0.02, (BATCH, SEQ_LEN, 1)
    )
    u = np.concatenate((pwm, tilt, ts), axis=-1).astype(np.float32)
    y = (rng.normal(size=(BATCH, SEQ_LEN, 22)) * 0.1).astype(np.float32)
    q = rng.normal(size=(BATCH, SEQ_LEN, 4))
    y[..., 12:16] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    return model, params, u, y


class Step:
    """Full optimizer steps of ``model`` on one fixed batch ``(u, y)``:
    the conditioned loss, its gradient (zeros for a leaf the loss does
    not reach, as in JAX) and the Trainer's Adam update at ``lr``
    (optax's defaults). Nothing is read back."""

    def __init__(self, model, params, u, y, lr: float):
        self.model = model
        self.leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
        self.params = params.with_tensors(self.leaves)
        self.states = [{} for _ in self.leaves]
        self.lr = float(lr)
        kw = dict(dtype=model.dtype, device=model.device)
        self.u, self.y = torch.as_tensor(u, **kw), torch.as_tensor(y, **kw)

    def __call__(self, generator=None, noise=None):
        """One step, its noise drawn from ``generator`` or given as
        ``noise``; returns the detached loss and the gradient leaves."""
        loss, _ = self.model.loss(self.params, self.u, self.y, generator, True, None, noise)
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.leaves, grads)]
        adam_update(self.leaves, grads, self.states, self.lr)
        return loss.detach(), grads

    def chunk(self, steps: int, seed: int) -> float:
        """``steps`` steps issued back to back, their noise from one
        generator on the model's device seeded ``seed``; the last loss,
        read back once."""
        generator = torch.Generator(device=self.model.device).manual_seed(seed)
        for _ in range(steps):
            loss, _ = self(generator)
        return loss.item()


def measure(steps: int = STEPS, warmup: int = WARMUP, device="cuda") -> float:
    """Steps/sec of the headline step: the median of 3 timed chunks of
    ``steps`` after ``max(2, warmup)`` warm ones, each timed from its
    first issue to its readback."""
    model, params, u, y = build_voliro_parts(device=device)
    step = Step(model, params, u, y, LEARNING_RATE)
    for i in range(max(2, warmup)):
        step.chunk(steps, i)
    rates = []
    for rep in range(3):
        t0 = time.perf_counter()
        final = step.chunk(steps, 7 + rep)
        rates.append(steps / (time.perf_counter() - t0))
    if not np.isfinite(final):
        print(f"warning: non-finite loss {final}", file=sys.stderr)
    return float(np.median(rates))


# --- analytic FLOPs -----------------------------------------------------


def voliro_analytic_gflops() -> float:
    """Analytic matmul GFLOPs per Voliro optimizer step (bench config).
    GP links only (the symplectic-Euler physics is elementwise);
    logical FLOPs, x3 for reverse mode."""
    n_force, m = BATCH * SEQ_LEN, 20  # batched force GP: [B*T, 12] -> 3
    force = 2 * n_force * (12 * m + m * (m + 3) + m * 3)
    n_bwd = BATCH * SAMPLES  # backward recursion: T links of [B*S, 19] -> 6
    bwd = SEQ_LEN * 2 * n_bwd * (19 * m + m * (m + 6) + m * 6)
    return 3.0 * (force + bwd) / 1e9


def cbfssm_analytic_gflops(shape) -> float:
    """Analytic matmul GFLOPs per optimizer step for a CBFSSM shape: the
    dominant GP-link matmuls of both recursions, x3 for reverse mode;
    logical FLOPs."""
    from cbfssm_tpu_torch.models.segmentation import blocked_layout

    t, m = shape["seq_len"], shape["m"]
    dx, du, dy = shape["dim_x"], shape["dim_u"], shape["dim_y"]
    dh, din, n = dx - dy, dx + du, shape["batch"] * shape["samples"]
    # forward: T-1 links of [N,din]x[din,M] + [N,M]x[M,M+dx] + [N,M]x[M,dx]
    fwd = (t - 1) * 2 * n * (din * m + m * (m + dx) + m * dx)
    # blocked backward: 2L links of [2*K*N, .] with out dim dh
    two_l = 2 * shape["recog_len"]
    bwd = 0
    if dh > 0 and t > two_l:
        _, k_blocks, _ = blocked_layout(t, shape["recog_len"])
        nb = 2 * k_blocks * n
        bwd = two_l * 2 * nb * (din * m + m * (m + dh) + m * dh)
    return 3.0 * (fwd + bwd) / 1e9


def mfu_vs_f32_peak(gflops: float, steps_per_sec: float) -> float:
    """The share of the card's float32 peak that ``gflops`` a step at
    ``steps_per_sec`` reaches (a few millionths at the headline shape,
    so it is not rounded)."""
    return gflops * 1e9 * steps_per_sec / PEAK_FLOPS["float32"]


# --- the CBFSSM shapes --------------------------------------------------


def cbfssm_config(shape) -> dict:
    """The CBFSSM config of a benchmark shape (float32, ``solve_free``)."""

    class _DS:
        dim_u = shape["dim_u"]
        dim_y = shape["dim_y"]

    dim_x = shape["dim_x"]
    return {
        "ds": _DS,
        "batch_size": shape["batch"],
        "shuffle": 10000,
        "dim_x": dim_x,
        "ind_pnt_num": shape["m"],
        "samples": shape["samples"],
        "learning_rate": shape["lr"],
        "loss_factors": np.asarray([20.0, 0.0]),
        "k_factor": 1.0,
        "recog_len": shape["recog_len"],
        "zeta_pos": 2.0,
        "zeta_mean": 0.1**2,
        "zeta_var": 0.01**2,
        "var_x": np.asarray([0.1**2] * dim_x),
        "var_y": np.asarray([1.0**2] * dim_x),
        "gp_var": 0.1**2,
        "gp_len": 1.0,
        "dtype": "float32",
        "scan_unroll": 1,
        "gp_impl": "solve_free",
        "backward_mode": "auto",
        "adjoint": "auto",
    }


def build_cbfssm_parts(shape, device="cuda"):
    """(model, params, u, y) of a benchmark shape: ``CBFSSM`` on
    ``device``, its params (``model.init`` from seed 0) and
    standard-normal inputs from ``np.random.default_rng(0)``."""
    from cbfssm_tpu_torch.models import CBFSSM

    model = CBFSSM(cbfssm_config(shape), device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    size = (shape["batch"], shape["seq_len"])
    u = rng.normal(size=size + (shape["dim_u"],)).astype(np.float32)
    y = rng.normal(size=size + (shape["dim_y"],)).astype(np.float32)
    return model, params, u, y


def measure_cbfssm_shapes(steps: int = 10, reps: int = 2, device="cuda") -> dict:
    """Steps/sec, analytic GFLOPs and MFU of each shape of :data:`SHAPES`:
    two warm 1-chunk blocks, the block size calibrated to about a second
    (``min(50, max(1, rate / steps))`` chunks, one warm block), the median
    of ``reps`` timed blocks. A block is its chunks issued back to back
    with one readback at its end. A shape that fails gets an ``error``."""
    out = {}
    for name, shape in sorted(SHAPES.items()):
        try:
            model, params, u, y = build_cbfssm_parts(shape, device=device)
            step = Step(model, params, u, y, shape["lr"])

            def timed(n_dispatch: int, seed: int) -> float:
                t0 = time.perf_counter()
                for j in range(n_dispatch):
                    generator = torch.Generator(device=model.device).manual_seed(seed + j)
                    for _ in range(steps):
                        loss, _ = step(generator)
                loss.item()
                return n_dispatch * steps / (time.perf_counter() - t0)

            for i in range(2):
                cal = timed(1, 100 * i)
            n_dispatch = int(min(50, max(1, cal / steps)))
            timed(n_dispatch, 500)
            rates = [timed(n_dispatch, 1000 * (10 + rep)) for rep in range(reps)]
            sps = float(np.median(rates))
            gflops = cbfssm_analytic_gflops(shape)
            out[name] = {
                "steps_per_sec": round(sps, 3),
                "analytic_gflop_per_step": round(gflops, 3),
                "mfu_vs_f32_peak": mfu_vs_f32_peak(gflops, sps),
            }
        except Exception as exc:  # a side shape never kills the headline
            out[name] = {"error": f"{type(exc).__name__}: {exc}"[:200]}
    return out


# --- the production loops -------------------------------------------------


def _mark_epochs(trainer, marks: list) -> None:
    """Wraps ``trainer._dispatch_block`` and ``_log_epoch``: every logged
    epoch appends (epochs issued so far, host time). An epoch is logged
    after its losses are read back, and a block's epochs after the next
    block was issued: the host issues a block's steps eagerly, so those
    are done too, but for the card's queue."""
    issued = [0]
    dispatch, log = trainer._dispatch_block, trainer._log_epoch

    def dispatch_block(ds, batch_size, start, k, *args):
        handles = dispatch(ds, batch_size, start, k, *args)
        issued[0] = start + k
        return handles

    def log_epoch(epoch, *args, **kwargs):
        marks.append((max(issued[0], epoch + 1), time.perf_counter()))
        return log(epoch, *args, **kwargs)

    trainer._dispatch_block, trainer._log_epoch = dispatch_block, log_epoch


def _tail_seconds_per_epoch(marks, warm: int, epochs: int, t0: float, t_end: float) -> float:
    """Seconds an epoch of the steady tail: from the first mark with at
    least ``warm`` (and fewer than ``epochs``) epochs issued to the end of
    training, over the epochs still to run then. When no mark qualifies
    (one block covers every epoch), the whole run from ``t0``."""
    done, t_start = next(((c, t) for c, t in marks if warm <= c < epochs), (0, t0))
    return (t_end - t_start) / (epochs - done)


def build_ds(device="cuda"):
    """(model, ds): the headline model and a synthetic Voliro dataset of
    :data:`N_TRAIN_WINDOWS` / :data:`N_TEST_WINDOWS` windows, copies of the
    headline batch with N(0, 1e-3) jitter from ``default_rng(7)``."""
    model, _, u, y = build_voliro_parts(device=device)
    rng = np.random.default_rng(7)

    def windows(n):
        uu = np.concatenate([u] * (-(-n // BATCH)))[:n]
        yy = np.concatenate([y] * (-(-n // BATCH)))[:n]
        # decorrelate repeated copies so shuffling is meaningful
        yy = yy + rng.normal(0, 1e-3, yy.shape).astype(yy.dtype)
        return uu, yy

    class _DS:
        dim_u = 13
        dim_y = 22
        seq_len = SEQ_LEN

        def __init__(self):
            self.train_in_batch, self.train_out_batch = windows(N_TRAIN_WINDOWS)
            self.test_in_batch, self.test_out_batch = windows(N_TEST_WINDOWS)

    return model, _DS()


def measure_trainer(epd="auto", epochs: int = 100, device="cuda") -> float:
    """Steps/sec of ``Trainer.train`` end to end (shuffles, steps, test
    loss, logging, checkpoints) at the headline shape with
    ``epochs_per_dispatch=epd``: the steady tail after
    :data:`WARM_EPOCHS`, counted in epochs issued (:func:`_mark_epochs`):
    the JAX bench counts the epochs logged, which here trail the issued
    ones by a block. With too few epochs for a mark past the warm-up
    (20 at blocks of 10) the whole run is timed. Training's stdout goes
    to stderr."""
    from cbfssm_tpu_torch.training import Trainer

    if epochs <= WARM_EPOCHS:
        raise ValueError(f"epochs must exceed the {WARM_EPOCHS}-epoch warmup (got {epochs})")
    model, ds = build_ds(device)
    marks = []
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(sys.stderr):
        trainer = Trainer(model, d, epochs_per_dispatch=epd, seed=0)
        _mark_epochs(trainer, marks)
        t0 = time.perf_counter()
        trainer.train(ds, epochs)
        t_end = time.perf_counter()
    if not np.isfinite(trainer.train_all).all():
        print("warning: non-finite train losses", file=sys.stderr)
    steps_per_epoch = -(-N_TRAIN_WINDOWS // BATCH)
    return steps_per_epoch / _tail_seconds_per_epoch(marks, WARM_EPOCHS, epochs, t0, t_end)


def measure_multiseed(seeds: int = 5, epochs: int = 30, warm: int = WARM_EPOCHS,
                      device="cuda") -> float:
    """Seconds an epoch of a ``seeds``-lane ``MultiSeedTrainer`` on the
    Spring data at run_spring.py's config (shuffles, lane steps, test
    loss, best tracking, blocks of ``epochs_per_dispatch='auto'``): the
    steady tail after ``warm`` epochs, marked where ``train`` has read an
    epoch's (or a block's) losses back. Training's stdout goes to
    stderr."""
    from cbfssm_tpu_torch import run_spring
    from cbfssm_tpu_torch.data import SpringNonlinear
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.training import MultiSeedTrainer

    with contextlib.redirect_stdout(sys.stderr):
        ds = SpringNonlinear(run_spring.seq_len, run_spring.seq_stride)
    model = CBFSSM(run_spring.model_config, device=device)
    marks = []
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(sys.stderr):
        trainer = MultiSeedTrainer(model, d, n_seeds=seeds)
        _mark_epochs(trainer, marks)
        t0 = time.perf_counter()
        trainer.train(ds, epochs)
        t_end = time.perf_counter()
    return _tail_seconds_per_epoch(marks, warm, epochs, t0, t_end)


# --- the CPU baseline -------------------------------------------------------


def cpu_name() -> str:
    """This host's CPU model, as ``/proc/cpuinfo`` names it."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def cpu_baseline() -> tuple:
    """(steps/sec, error) of the headline step on this host's CPU: the
    cache, or a child process of this module (``CBFSSM_BENCH_CPU_CHILD=1``,
    no visible card) whose last stdout line carries the value. The cache
    is written whole or not at all; an unreadable one is measured again.
    A failed child gives ``(None, reason)``."""
    if BASELINE_CACHE.is_file():
        try:
            return float(json.loads(BASELINE_CACHE.read_text())["cpu_torch_steps_per_sec"]), None
        except (ValueError, KeyError, TypeError, OSError) as exc:
            # a torn cache must be measured again, not crash every run
            print(f"baseline cache unreadable ({exc}); remeasuring", file=sys.stderr)
    env = dict(os.environ, CBFSSM_BENCH_CPU_CHILD="1", CUDA_VISIBLE_DEVICES="")
    try:
        out = subprocess.run([sys.executable, *CPU_CHILD], env=env, cwd=PACKAGE_PARENT,
                             capture_output=True, text=True, timeout=1800)
        child = json.loads(out.stdout.strip().splitlines()[-1])
        value = float(child["value"])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError, KeyError,
            TypeError) as exc:
        msg = f"{type(exc).__name__}: {exc}"
        print(f"cpu baseline measurement failed ({msg})", file=sys.stderr)
        return None, msg[:500]
    BASELINE_CACHE.parent.mkdir(parents=True, exist_ok=True)
    tmp = BASELINE_CACHE.with_name(f"{BASELINE_CACHE.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps({"cpu_torch_steps_per_sec": value, "cpu": child.get("cpu"),
                               "torch_threads": child.get("torch_threads")}))
    os.replace(tmp, BASELINE_CACHE)
    return value, None


# --- the result line and abort handling -------------------------------------


def device_info() -> dict:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (torch's name and no limit where nvidia-smi fails)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        name, limit = (s.strip() for s in smi.stdout.strip().splitlines()[0].split(",", 1))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": torch.cuda.get_device_name(0), "power_limit": None}
    return {"name": name, "power_limit": limit}


def _emit_json(results, error=None, stage=None) -> dict:
    """Print the ONE JSON line and return it: metric, value, unit and
    vs_baseline always; ``error`` / ``stage`` on an abort; every stage
    measured so far (a key that was not measured stays absent)."""
    payload = {
        "metric": "voliro_elbo_steps_per_sec",
        "value": results.get("value"),
        "unit": "steps/sec",
        "vs_baseline": results.get("vs_baseline"),
    }
    if error is not None:
        payload["error"] = str(error)[:500]
        payload["stage"] = stage
    for key in (
        "baseline_error",
        "steps_per_sec_300_per_dispatch",
        "trainer_blocked_steps_per_sec",
        "multiseed_5x_s_per_epoch",
        "analytic_gflop_per_step",
        "mfu_vs_f32_peak",
        "shapes",
        "device",
        "stage_seconds",
    ):
        if key in results:
            payload[key] = results[key]
    print(json.dumps(payload), flush=True)
    return payload


def _install_signal_salvage(stage, results) -> None:
    """On SIGTERM or SIGINT (the caller's timeout), print the partial
    result line before dying, as the watchdog does."""
    import signal

    def handler(signum, frame):
        msg = f"terminated by signal {signum}"
        print(f"bench: {msg}", file=sys.stderr, flush=True)
        _emit_json(results, error=msg, stage=stage["name"])
        os._exit(3)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, handler)
        except (ValueError, OSError):  # not the main thread
            pass


def _start_watchdog(stage, results, first_timeout: float = 900.0,
                    total_timeout: float = 10800.0, poll: float = 15.0,
                    emit: bool = True) -> None:
    """A daemon thread that ends the run (exit 3) when the first stage
    has not finished within ``first_timeout`` or the whole run exceeds
    ``total_timeout`` (``CBFSSM_BENCH_TOTAL_TIMEOUT`` overrides it),
    printing the partial result line first unless ``emit`` is False. The
    total is sized for a whole run of the eager port on the card: the
    Trainer's 3,000 steps and the multi-seed stage's 30 Spring epochs
    take tens of minutes each."""
    import threading

    total_timeout = float(os.environ.get("CBFSSM_BENCH_TOTAL_TIMEOUT", total_timeout))
    t0 = time.monotonic()

    def abort(msg):
        print(f"bench watchdog: {msg}", file=sys.stderr, flush=True)
        if emit:
            _emit_json(results, error=msg, stage=stage["name"])
        os._exit(3)

    def run():
        while True:
            time.sleep(poll)
            elapsed = time.monotonic() - t0
            if stage["name"] == "backend-init" and elapsed > first_timeout:
                abort(f"no headline after {elapsed:.0f}s (the card hung?)")
            if elapsed > total_timeout:
                abort(f"run exceeded {total_timeout:.0f}s at stage '{stage['name']}'")

    threading.Thread(target=run, daemon=True).start()


def main() -> None:
    stage = {"name": "backend-init"}
    results = {}
    if os.environ.get("CBFSSM_BENCH_CPU_CHILD"):
        # the parent parses this process's last stdout line as the
        # cpu_child record, so a watchdog abort here stays on stderr
        if not os.environ.get("CBFSSM_BENCH_NO_WATCHDOG"):
            _start_watchdog(stage, results, emit=False)
        stage["name"] = "cpu-child-measuring"
        sps = measure(steps=5, warmup=2, device="cpu")
        print(json.dumps({"metric": "cpu_child", "value": sps, "unit": "steps/sec",
                          "cpu": cpu_name(), "torch_threads": torch.get_num_threads()}))
        return
    _install_signal_salvage(stage, results)
    if not os.environ.get("CBFSSM_BENCH_NO_WATCHDOG"):
        _start_watchdog(stage, results)
    try:
        _run_stages(stage, results)
    except SystemExit:
        raise
    except BaseException as exc:
        # a stage that raises: print what was measured before it
        msg = f"{type(exc).__name__}: {exc}"
        print(f"bench: stage '{stage['name']}' raised: {msg}", file=sys.stderr, flush=True)
        _emit_json(results, error=msg, stage=stage["name"])
        sys.exit(3)


def _run_stages(stage, results) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the bench measures the card")
    results["device"] = device_info()
    seconds = results["stage_seconds"] = {}

    def timed(label, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[label] = round(time.perf_counter() - t0, 3)

    sps = timed("headline", measure)
    stage["name"] = "headline-measured"
    gflops = voliro_analytic_gflops()
    results["value"] = round(sps, 3)
    results["analytic_gflop_per_step"] = round(gflops, 3)
    results["mfu_vs_f32_peak"] = mfu_vs_f32_peak(gflops, sps)
    stage["name"] = "cpu-baseline"
    base, base_error = timed("cpu-baseline", cpu_baseline)
    results["vs_baseline"] = None if base is None else round(sps / base, 2)
    if base_error is not None:
        results["baseline_error"] = base_error
    if not os.environ.get("CBFSSM_BENCH_HEADLINE_ONLY"):
        stage["name"] = "shapes"
        results["shapes"] = timed("shapes", measure_cbfssm_shapes)
        stage["name"] = "large-chunk"
        results["steps_per_sec_300_per_dispatch"] = round(
            timed("large-chunk", measure, steps=300, warmup=2), 3)
        stage["name"] = "trainer-blocked"
        try:
            results["trainer_blocked_steps_per_sec"] = round(
                timed("trainer-blocked", measure_trainer), 3)
        except Exception as exc:  # an extra metric never kills the headline
            print(f"trainer-blocked measurement failed: {exc}", file=sys.stderr)
        stage["name"] = "multiseed"
        try:
            results["multiseed_5x_s_per_epoch"] = round(timed("multiseed", measure_multiseed), 4)
        except Exception as exc:
            print(f"multiseed measurement failed: {exc}", file=sys.stderr)
    stage["name"] = "emit"
    return _emit_json(results)


if __name__ == "__main__":
    main()
