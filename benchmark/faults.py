"""A fault a training cell can have, planted under the program's
``Trainer.train_step`` for as long as :func:`planted` lasts: for the
calibration's readings (``benchmark/calibrate.py``) and the tests. A
benchmark run plants none."""

from __future__ import annotations

import contextlib

import torch


def half_batch(orig):
    """Half of each batch left out, the mean taken over the rest: the
    weights of the second half set to 0, the first half's doubled."""
    def step(self, u, y, w, generator=None, noise=None):
        keep = torch.ones_like(w)
        keep[w.shape[0] // 2:] = 0.0
        return orig(self, u, y, w * keep * 2.0, generator, noise)
    return step


@contextlib.contextmanager
def planted(fault):
    """``Trainer.train_step`` replaced by ``fault(Trainer.train_step)``."""
    from cbfssm_tpu_torch.training import Trainer

    orig = Trainer.train_step
    Trainer.train_step = fault(orig)
    try:
        yield
    finally:
        Trainer.train_step = orig
