"""Device time of a kernel, and the operands the kernel checks use.

:func:`graph_replay_ms` times a kernel by capturing ``launches``
back-to-back calls in one CUDA graph and replaying it: CUDA events around
the replays, divided by the number of calls. The host's issue time is
then out of the figure, which back-to-back eager calls of a 10-80 us
kernel do not achieve. :func:`kernel_inputs`, :func:`clamp_kernel_inputs`
and :data:`KERNEL_SHAPES` are the operands and shapes at which
``chip_smoke.py`` and the ``cuda`` tests hold the fused GP-predict
kernels against their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

# Shapes (N, M, DI, D) of the kernel checks on the card: the two RoboMove
# shapes, a ragged one, and edges of the kernel's tiling (on a 132-SM
# card the row tile is 4 below N = 1,057, 8 at N = 1,601 and 52 at
# N = 12,689; the micro-tile is 4 x 4): M = 1, 7, 13, 100, 101 (not all
# multiples of 4), N = 1, N = 3 (below one tile), N = 5, 53, 1,601 and
# 12,689 (one row past a tile boundary), D = 1..5 (above 4 the reduction
# takes a second pass) and DI = 1..8.
KERNEL_SHAPES = [(12800, 100, 6, 2), (1600, 100, 6, 4), (37, 11, 5, 3),
                 (1, 1, 1, 1), (3, 7, 2, 1), (5, 13, 3, 2), (53, 101, 8, 4),
                 (1601, 100, 6, 4), (12689, 101, 7, 3), (9, 13, 4, 5)]

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
