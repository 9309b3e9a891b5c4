"""cbfssm_tpu_torch — the PyTorch/CUDA port of ``cbfssm_tpu``.

A second package beside the JAX one, written for one NVIDIA H100. It
imports ``torch`` and never ``jax``, ``flax``, ``optax`` or ``orbax``;
the JAX package is the reference it is tested against.

It serves and trains ``CBFSSM``, ``CBFSSMHALF`` and ``PRSSM``, and
trains ``Voliro``:

- :mod:`cbfssm_tpu_torch.ops`     — transforms, RBF kernel, Cholesky,
  distributions, quaternions, sparse GP, and the fused GP predict (CUDA
  kernel ``csrc/gp_predict.cu`` beside its plain torch version).
- :mod:`cbfssm_tpu_torch.models`  — ``CBFSSM``, ``CBFSSMHALF`` and
  ``Voliro`` (with their streaming entry points) and ``PRSSM``, and the
  recognition nets.
- :mod:`cbfssm_tpu_torch.data`    — the datasets (RoboMove, Spring,
  Voliro flight logs, the system-identification tasks), windowing,
  generators and synthetic raw files.
- ``cbfssm_tpu_torch.run_*``      — the reproduction drivers.
- :mod:`cbfssm_tpu_torch.serving` — fixed-shape, bucketed and
  micro-batched predictors, with checkpoint hot-swap.
- :mod:`cbfssm_tpu_torch.serving_http` — the stdlib HTTP predictor
  server (``PredictionServer``).
- :mod:`cbfssm_tpu_torch.model_store` — ``model_meta.json``: a trained
  directory rebuilt from disk alone.
- ``python -m cbfssm_tpu_torch`` — the command line: ``info``,
  ``reproduce``, ``eval``, ``serve``.
- :mod:`cbfssm_tpu_torch.convert` — parameters from the JAX package's
  leaves, given as numpy arrays.
"""

__version__ = "0.1.0"

from cbfssm_tpu_torch import ops  # noqa: F401
