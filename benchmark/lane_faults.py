"""Faults a lane cell can have, planted under the program's
``MultiSeedTrainer.train_step`` for as long as :func:`planted` lasts: for
the calibration's readings (``benchmark/calibrate_lanes.py``) and the
tests. A benchmark run plants none.

- :func:`half_batch`: half of each lane's batch left out, the mean taken
  over the rest;
- :func:`frozen`: a step hands its state back unchanged (parameters,
  Adam's moments and step counts as before it);
- :func:`swapped_draws`: lanes 0 and 1 take each other's draws.
"""

from __future__ import annotations

import contextlib

import torch


def half_batch(orig):
    def step(self, u, y, w, noises):
        keep = torch.ones_like(w)
        keep[:, w.shape[1] // 2:] = 0.0
        return orig(self, u, y, w * keep * 2.0, noises)
    return step


def frozen(orig):
    def step(self, u, y, w, noises):
        before = [p.detach().clone() for p in self.params.tensors()]
        out = orig(self, u, y, w, noises)
        with torch.no_grad():
            for p, b in zip(self.params.tensors(), before):
                p.copy_(b)
            for t in self.opt.exp_avg + self.opt.exp_avg_sq + [self.opt.step_count]:
                t.zero_()
        return out
    return step


def swapped_draws(orig):
    def step(self, u, y, w, noises):
        noises = list(noises)
        noises[0], noises[1] = noises[1], noises[0]
        return orig(self, u, y, w, noises)
    return step


FAULTS = {"half_batch": half_batch, "frozen": frozen, "swapped_draws": swapped_draws}


@contextlib.contextmanager
def planted(fault):
    """``MultiSeedTrainer.train_step`` replaced by ``fault(train_step)``."""
    from cbfssm_tpu_torch.training import MultiSeedTrainer

    orig = MultiSeedTrainer.train_step
    MultiSeedTrainer.train_step = fault(orig)
    try:
        yield
    finally:
        MultiSeedTrainer.train_step = orig
