"""CUDA graphs of the Trainer's train step and test batch.

A train step launches tens of thousands of small kernels, one Python
call each, and on the card the host's launching, not the card, sets the
step's pace. So on a CUDA device the :class:`~cbfssm_tpu_torch.training.Trainer`
captures the step (forward, ``loss.backward()``, the guard and
``adam_update``) once as a CUDA graph and then replays it: one launch a
step. A test batch's loss is a second graph in the same memory pool.

- A graph's key is the split, the batch's shapes and dtypes and the
  learning rate. The tensors the step reads and writes besides its
  batch (the leaves and Adam's state) live as long as the Trainer,
  which writes new values into them in place, so one graph serves every
  ``train()``, ``restore()`` and checkpoint load.
- A key is captured once its batch shapes have run eagerly in the
  Trainer (the first run makes the step's device constants and warms
  cuBLAS and the allocator): the first train step and test batch of a
  Trainer's first ``train()`` run eagerly and the second are captured.
  Every later step with the key is one replay. The captured step also
  runs by a replay: a capture runs nothing.
- The graph reads its batch from static buffers (:class:`StaticBatch`):
  the Trainer gathers the batch straight into them, and the draws are
  made into them from the batch's generator in the order the model
  draws them (``draw_noise(..., out=)``), or copied from ``noise_fn``'s.
  The replay runs the eager step's kernels on the same numbers, so
  losses, leaves and Adam state are bitwise the eager path's.
- A capture that fails leaves its key eager for good: the Trainer says
  so once on stderr and counts it.
- The kernel wrappers count a call under capture in their ``captures``
  (``fused_predict.captures``, ...), not as a launch; a graph keeps
  what its capture recorded (:attr:`StepGraph.kernels`), and each
  replay adds it to :data:`replayed`, the GP kernels the replays ran,
  apart from the wrappers' launches (:func:`launches` sums the two).
"""

from __future__ import annotations

import torch

from cbfssm_tpu_torch.models.base import noise_tensors
from cbfssm_tpu_torch.ops import fused_predict as fp

FALLBACK = "fallback"  # a key whose capture failed: eager from then on

# each GP kernel: its wrapper and the prefix of its counters there
# (``launches``, ``captures``)
_KERNELS = {"gp_predict": (fp.fused_predict, ""),
            "gp_predict_residuals": (fp.fused_predict_residuals, ""),
            "gp_predict_lanes": (fp.fused_predict, "lane_"),
            "gp_predict_residuals_lanes": (fp.fused_predict_residuals, "lane_")}

# the GP kernel launches that graph replays ran, by kernel, over the process
replayed = dict.fromkeys(_KERNELS, 0)


def eligible(device, mesh, particle: bool) -> bool:
    """Whether a Trainer graphs its steps: on a CUDA device, with no mesh
    and no ``ParticleParallel`` model (their steps talk to other ranks)."""
    return torch.device(device).type == "cuda" and mesh is None and not particle


def _counts(name: str) -> dict:
    return {k: getattr(f, prefix + name) for k, (f, prefix) in _KERNELS.items()}


def launches() -> dict:
    """The GP kernel launches the card ran over the process, by kernel:
    the wrappers' own and the graph replays' (:data:`replayed`)."""
    return {k: n + replayed[k] for k, n in _counts("launches").items()}


class StaticBatch:
    """A graph's inputs: the batch's ``u``, ``y``, weights ``w`` and draws
    ``noise`` (the model's ``draw_noise`` structure), on the device."""

    def __init__(self, model, u, y, w):
        self.u, self.y, self.w = (torch.empty_like(t) for t in (u, y, w))
        # buffers of the draws' shapes; their numbers are drawn at stage()
        scratch = torch.Generator(device=model.device).manual_seed(0)
        self.noise = model.draw_noise(scratch, u.shape[1], u.shape[0])

    def stage(self, model, u, y, w, generator, noise) -> None:
        """Fill the buffers with the batch (a tensor the Trainer gathered
        into its buffer is not copied again) and its draws: from
        ``generator``, or ``noise``'s tensors."""
        for dst, src in ((self.u, u), (self.y, y), (self.w, w)):
            if src is not dst:
                dst.copy_(src)
        if noise is None:
            model.draw_noise(generator, self.u.shape[1], self.u.shape[0], out=self.noise)
            return
        for dst, src in zip(noise_tensors(self.noise), noise_tensors(noise), strict=True):
            if dst.shape != src.shape:
                raise ValueError(f"noise of shape {list(src.shape)} where the model draws "
                                 f"{list(dst.shape)}")
            dst.copy_(src)


class StepGraph:
    """A captured step: its graph, inputs and outputs, and the GP kernel
    launches its capture recorded (``kernels``, by kernel)."""

    def __init__(self, body, batch: StaticBatch, pool, stream):
        """Capture ``body`` on ``batch`` into the memory ``pool`` on
        ``stream`` (the graphs of one pool share their stream)."""
        self.batch = batch
        self.graph = torch.cuda.CUDAGraph()
        before = _counts("captures")
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.outputs = body(batch.u, batch.y, batch.w, None, batch.noise)
        finally:
            self.kernels = {k: n - before[k] for k, n in _counts("captures").items()}

    def replay(self) -> tuple:
        """Run the step; returns fresh copies of its outputs (the graph's
        own are overwritten by the next replay)."""
        self.graph.replay()
        for k, n in self.kernels.items():
            replayed[k] += n
        return tuple(t.clone() for t in self.outputs)
