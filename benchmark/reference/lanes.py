"""The rules by which a lane program (the port's multi-seed trainer)
gives each lane its own shuffles and draws, worked out again for the
reference. Imports nothing of the program.

- Shuffles: one ``np.random.default_rng(seed)`` for the whole run; each
  epoch draws one shuffled epoch (:func:`common.epoch_batches`) a lane,
  in lane order.
- Draws: a lane's draws for batch ``i`` of ``split`` (0 train, 1 test)
  in ``epoch`` come from a generator on the device seeded by the first
  64-bit word of ``SeedSequence([seed + 1, epoch, split, lane, i])``,
  one standard-normal call a shape, in order: the Trainer's rule
  (:func:`common.trainer_draws`) with the lane before the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import common


def lane_seed(seed: int, epoch: int, split: int, lane: int, i: int) -> int:
    return int(np.random.SeedSequence([seed + 1, epoch, split, lane, i])
               .generate_state(1, np.uint64)[0])


def lane_draws(shapes, seed: int, epoch: int, split: int, lane: int, i: int, dtype,
               device) -> list:
    """The draws lane ``lane`` of a program seeded ``seed`` makes itself
    for batch ``i`` of ``split`` in ``epoch``."""
    gen = torch.Generator(device=device).manual_seed(lane_seed(seed, epoch, split, lane, i))
    return [torch.randn(s, generator=gen, dtype=dtype, device=device) for s in shapes]


def first_lane_batches(seed: int, n: int, batch: int, steps: int, lanes: int) -> list:
    """Each lane's windows and weights of the first ``steps`` optimizer
    steps over ``n`` training windows: ``[lane][step] -> (indices [B],
    weights [B])``."""
    rng = np.random.default_rng(seed)
    out = [[] for _ in range(lanes)]
    while len(out[0]) < steps:
        for lane in range(lanes):
            idx, w = common.epoch_batches(rng, n, batch)
            out[lane].extend(zip(idx, w))
    return [o[:steps] for o in out]
