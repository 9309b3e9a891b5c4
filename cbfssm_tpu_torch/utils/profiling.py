"""Structured metrics and step timing (port of
``cbfssm_tpu/utils/profiling.py``: :class:`MetricsLogger` and
:class:`StepTimer`). The device trace (``trace``) waits for a
``torch.profiler`` port (ROADMAP A6.3).
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Append-only JSONL event stream (one JSON object per line)."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            # truncate: one file per run
            open(path, "w").close()

    def log(self, **event) -> None:
        if not self.path:
            return
        event.setdefault("time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")


class StepTimer:
    """Steps/sec over a sliding window, discarding warmup steps."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._count = 0
        # warmup=0 has no warmup tick to start the clock on, so the
        # window starts at construction
        self._t0 = time.perf_counter() if warmup == 0 else None
        self._timed_steps = 0

    def tick(self) -> None:
        # a tick marks the END of a step; the clock starts when the
        # warmup-th tick lands, and every later tick is a timed step
        self._count += 1
        if self._count == self.warmup:
            self._t0 = time.perf_counter()
        elif self._count > self.warmup:
            self._timed_steps += 1

    @property
    def steps_per_sec(self) -> float | None:
        if self._t0 is None or self._timed_steps == 0:
            return None
        return self._timed_steps / (time.perf_counter() - self._t0)
