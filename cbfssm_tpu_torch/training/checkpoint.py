"""Checkpoint save/restore (port of ``cbfssm_tpu/training/checkpoint.py``).

Best-by-train-loss goes to ``best.ckpt``, the final state to
``model.ckpt``; evaluation restores best, curriculum retraining restores
last. A checkpoint is one ``torch.save`` file of
``{"params": [tensor, ...], "opt_state": optimizer.state_dict()}``
(params in the order of the params' ``tensors()``, all on the CPU), written to
a temporary file and renamed into place, so a reader never sees half a
file. The format is not the JAX package's orbax directory: neither
package reads the other's checkpoints. Weights cross over through
:mod:`cbfssm_tpu_torch.convert`.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

BEST = "best.ckpt"
LAST = "model.ckpt"


def _to_host(tree):
    """A copy of ``tree`` whose tensors and arrays are fresh host
    buffers: later in-place updates of the originals (the optimizer
    steps its state in place) never reach it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return np.array(tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _write(path: str, host_tree) -> None:
    """Write an already host-resident tree to ``path`` atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        torch.save(host_tree, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(path: str, tree) -> None:
    """Save ``tree`` (params / optimizer state) to ``path``."""
    _write(os.path.abspath(path), _to_host(tree))


def restore(path: str, map_location=None):
    """The tree saved at ``path``, its tensors on ``map_location``."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)


def exists(path: str) -> bool:
    return os.path.isfile(os.path.abspath(path))


class AsyncSaver:
    """Background checkpoint writer for training loops.

    ``save()`` copies the tree to the host on the CALLER's thread (the
    optimizer updates params and moments in place on the next step) and
    hands only the disk write to one worker thread. Saves of one path
    coalesce latest-wins: the worker writes the newest tree submitted for
    a path, so a backlog holds at most one pending host copy per path,
    and after ``flush()`` the files equal what synchronous saves would
    have left. ``flush(prefix)`` blocks until everything submitted is on
    disk and re-raises the first write error whose path lies under
    ``prefix`` (all errors when ``prefix`` is None).
    """

    def __init__(self):
        self._queue: queue.Queue = queue.Queue()
        self._latest: dict = {}  # path -> newest pending host tree
        self._errors: list = []  # (path, exc), scoped by flush(prefix)
        self._lock = threading.Lock()
        self._thread = None

    def _ensure_worker(self):
        # under the lock: concurrent save() calls must never start two
        # workers; latest-wins coalescing relies on one writer
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._work, name="cbfssm-torch-ckpt-writer", daemon=True
                )
                self._thread.start()

    def _work(self):
        while True:
            path = self._queue.get()
            try:
                with self._lock:
                    # None when a newer save of this path was already
                    # written by the ticket that superseded this one
                    host_tree = self._latest.pop(path, None)
                if host_tree is not None:
                    _write(path, host_tree)
            except Exception as exc:  # surfaced by flush()
                with self._lock:
                    self._errors.append((path, exc))
            finally:
                self._queue.task_done()

    def save(self, path: str, tree) -> None:
        """Copy ``tree`` to the host now; write it to ``path`` in the
        background. Call :meth:`flush` before reading it back."""
        host = _to_host(tree)
        path = os.path.abspath(path)
        with self._lock:
            self._latest[path] = host
        self._ensure_worker()
        self._queue.put(path)

    def flush(self, prefix: str | None = None) -> None:
        """Block until every submitted save is on disk; re-raise the
        first error under ``prefix`` (path-component scoped)."""
        self._queue.join()
        with self._lock:
            if prefix is None:
                mine, self._errors = self._errors, []
            else:
                root = os.path.abspath(prefix)

                def owns(path):
                    return path == root or path.startswith(root + os.sep)

                mine = [e for e in self._errors if owns(e[0])]
                self._errors = [e for e in self._errors if not owns(e[0])]
        if mine:
            raise mine[0][1]


_shared = None
_shared_lock = threading.Lock()


def shared_saver() -> AsyncSaver:
    """The process-wide saver the trainers use: one background writer
    thread for every Trainer in the process."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = AsyncSaver()
        return _shared
