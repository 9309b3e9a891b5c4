"""Counts the ops one training step of the PyTorch port dispatches, forward
and backward, under each gradient schedule: a host-side proxy for the
kernels a step launches on a GPU (views excluded, since they launch none).

    python scripts/torch_count_ops.py

Runs on the CPU at a tiny width (S 2, M 5, B 2) with the real step
counts: the RoboMove CBFSSM (seq 300, recog_len 50; pallas and
solve_free autodiff, solve_free 'hand') and Voliro (seq 64; solve_free
autodiff and 'parallel'). The counts do not depend on the data.
"""

from __future__ import annotations

import collections
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cbfssm_tpu_torch import run_robomove, run_voliro  # noqa: E402
from cbfssm_tpu_torch.models import CBFSSM, Voliro  # noqa: E402

TINY = {"samples": 2, "ind_pnt_num": 5, "batch_size": 2, "dtype": "float64"}


class CountOps(TorchDispatchMode):
    """Counts dispatched ops, views apart."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts["view" if func.is_view else "compute"] += 1
        return func(*args, **(kwargs or {}))


def step_ops(model, u, y) -> dict:
    params = model.init(torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_(True) for t in params.tensors()]
    counter = CountOps()
    with counter:
        loss, _ = model.loss(params.with_tensors(leaves), u, y,
                             torch.Generator().manual_seed(1), True)
        loss.backward()
    return dict(counter.counts)


def main():
    rng = np.random.default_rng(0)
    u, y = rng.normal(size=(2, 300, 2)), rng.normal(size=(2, 300, 2))
    for impl, adjoint in (("pallas", "autodiff"), ("solve_free", "autodiff"),
                          ("solve_free", "hand")):
        cfg = run_robomove.model_config(0, dict(TINY, gp_impl=impl, adjoint=adjoint))
        print(f"CBFSSM RoboMove {impl} {adjoint}: {step_ops(CBFSSM(cfg, device='cpu'), u, y)}")
    vu = rng.uniform(0.0, 1.0, size=(2, 64, 13))
    vu[..., 12] = 0.01 * np.arange(64)
    vy = rng.normal(size=(2, 64, 22))
    for adjoint in ("autodiff", "parallel"):
        cfg = dict(run_voliro.model_config, **TINY, gp_impl="solve_free", adjoint=adjoint)
        print(f"Voliro {adjoint}: {step_ops(Voliro(cfg, device='cpu'), vu, vy)}")


if __name__ == "__main__":
    main()
