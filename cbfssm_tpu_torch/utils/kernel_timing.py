"""Device time of a kernel, and the operands the kernel checks use.

:data:`PEAK_FLOPS` and :data:`PEAK_BYTES` are the card's published peaks.
:func:`graph_replay_ms` times a kernel by capturing ``launches``
back-to-back calls in one CUDA graph and replaying it: CUDA events around
the replays, divided by the number of calls. The host's issue time is
then out of the figure, which back-to-back eager calls of a 10-80 us
kernel do not achieve. :func:`kernel_inputs`, :func:`clamp_kernel_inputs`,
:func:`ill_conditioned_inputs` and :data:`KERNEL_SHAPES` are the
operands and shapes at which ``chip_smoke.py`` and the ``cuda`` tests
hold the fused GP-predict kernels against their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

# Published peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W
# limit (NVIDIA's data sheet): CUDA-core FP32 and FP64 operations a
# second and HBM3 bytes a second. ``chip_smoke.bound`` and
# ``cbfssm_tpu_torch.bench`` (``mfu_vs_f32_peak``) divide by them. The
# float32 training steps use no tensor cores (TF32 is off). The fused
# kernels run their product kmn @ [kinv | alpha] on the tensor cores:
# ``PEAK_TC`` is the dense tensor-core rate of that product, FP64 DMMA
# 67 TFLOP/s and float32 as 3xTF32, a third of TF32's 495 TFLOP/s.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_TC = {"float32": 495e12 / 3, "float64": 67e12}
PEAK_BYTES = 3.35e12

# Shapes (N, M, DI, D) of the kernel checks on the card: the two RoboMove
# shapes, a ragged one, and edges of the kernel's tiling. On a 132-SM
# card the row tile TN is 4 below N = 1,057, 8 at N = 1,601, 16 at
# N = 4,224, 20 at 4,225, 52 at N = 12,689 and 64 from N = 16,633; the
# mma tiles are 16 rows (8 in float64) by 8 columns, 8 deep (4 in
# float64), over the M + D columns of [kinv | alpha]. So: M = 1, 7, 8, 9,
# 13, 15, 16, 17, 100, 101, 104 and 105 (on both sides of the mma widths
# and depths; the M cap is tested apart, it depends on the card), N = 1,
# 3 (below one tile), 5, 15, 16, 17, 53, 63, 64, 65, 1,601, 4,224,
# 4,225, 12,689 and 16,900 (one row tile exactly, one row past a tile or
# an mma tile), D = 0 (no mean or variance column), 1..5 (above 4 the
# reduction takes a second pass) and 14, and DI = 1..8.
KERNEL_SHAPES = [(12800, 100, 6, 2), (1600, 100, 6, 4), (37, 11, 5, 3),
                 (1, 1, 1, 1), (3, 7, 2, 1), (5, 13, 3, 2), (53, 101, 8, 4),
                 (1601, 100, 6, 4), (12689, 101, 7, 3), (9, 13, 4, 5),
                 (15, 8, 3, 0), (16, 9, 2, 5), (17, 15, 6, 14), (63, 16, 4, 2),
                 (64, 17, 6, 4), (65, 104, 6, 0), (4224, 105, 6, 5), (4225, 104, 5, 14),
                 (16900, 105, 6, 3)]

# Shapes (N, M, DI, D) of the Voliro and Sarcos training paths at the
# widths of run_voliro.py (B 16, S 20, T 64, M 20) and run_sarcos.py
# (B 5, S 20, 9 recognition blocks, M 100). D = 6, 7 and 14 take two to
# four passes of the kernel's per-row reduction (4 columns a pass).
MODEL_SHAPES = {
    "voliro force": (1024, 20, 12, 3),
    "voliro recognition": (320, 20, 19, 6),
    "sarcos recognition": (1800, 100, 21, 7),
    "sarcos forward": (100, 100, 21, 14),
}

# Shapes (N, M, DI, D) of one online-filter tick (``gp_predict`` only):
# the RoboMove CBFSSMHALF at S 50 for a fleet of 1,024 sessions, of 32,
# and one stream; Voliro predicts its force GP once per session (N = B).
FILTER_SHAPES = {
    "fleet 1024": (51200, 100, 6, 4),
    "fleet 32": (1600, 100, 6, 4),
    "one stream": (50, 100, 6, 4),
    "voliro pool 8": (8, 20, 12, 3),
}


def kernel_inputs(rng, n, m, di, d, dtype, device):
    """Random well-conditioned predict operands (the construction of the
    JAX package's tests/test_pallas_gp.py make_inputs)."""

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    x = rng.normal(size=(n, di))
    z = rng.normal(size=(m, di))
    inv_ls = 1.0 / rng.uniform(0.5, 2.0, size=di)
    a = rng.normal(size=(m, m))
    kinv = np.linalg.inv(a @ a.T + m * np.eye(m))
    return (t(x), t(z * inv_ls), t(inv_ls), t(0.7), t(kinv),
            t(rng.normal(size=(m, d))), t(rng.uniform(0.01, 0.5, size=(m, d))))


def ill_conditioned_inputs(dtype, device, n=400, m=100, di=6, d=4, seed=0):
    """Predict operands whose kinv is ill-conditioned: the inverse of the
    jittered RBF Gram of ``m`` inducing points (kvar 0.7, lengthscale
    2.5 in every dimension, jitter 1e-6; condition number ~8.2e4 at the
    defaults, entries up to ~1.1e3), with ``n`` query rows, alpha normal
    and var_q uniform as in :func:`kernel_inputs`. Returns the operands
    and the Gram's condition number."""
    rng = np.random.default_rng(seed)
    inv_ls = np.full(di, 1 / 2.5)
    zs = rng.normal(size=(m, di)) * inv_ls
    gram = 0.7 * np.exp(-0.5 * ((zs[:, None] - zs[None]) ** 2).sum(-1)) + 1e-6 * np.eye(m)
    ops = (rng.normal(size=(n, di)), zs, inv_ls, 0.7, np.linalg.inv(gram),
           rng.normal(size=(m, d)), rng.uniform(0.01, 0.5, size=(m, d)))
    args = tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device) for a in ops)
    return args, float(np.linalg.cond(gram))


def clamp_kernel_inputs(dtype, device, n=6):
    """Operands (N = n, M = 11, DI = 5, D = 3) on which the d2 clamp
    engages, built as tests/test_pallas_gp.py's
    test_analytic_vjp_masks_d2_clamp builds them (n = 6): query row r
    lies within 1e-5 of the large-norm inducing point r % 11, so that
    |xs|^2 - 2 xs.zs + |zs|^2 cancels to rounding (|zs|^2 ~ 5e6). In
    float32 that rounding is a multiple of 0.5: emulated in numpy, 13 of
    64 such rows round below zero unclamped, which without the clamp
    would make kmn = kvar * e^0.25."""
    rng = np.random.default_rng(0)
    x, zs, inv_ls, kvar, kinv, alpha, var_q = (
        a.numpy() for a in kernel_inputs(rng, n, 11, 5, 3, torch.float64, "cpu"))
    zs = zs + 1e3
    x = (zs[np.arange(n) % 11] + rng.normal(size=x.shape) * 1e-5) / inv_ls
    return tuple(torch.tensor(a, dtype=dtype, device=device)
                 for a in (x, zs, inv_ls, kvar, kinv, alpha, var_q))


def graph_replay_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device ms per call of ``fn``: a CUDA graph of ``launches`` calls,
    replayed ``replays`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # first call outside the capture: build, attributes
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (launches * replays)
