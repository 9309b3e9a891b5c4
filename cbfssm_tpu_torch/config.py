"""Typed model configuration (PyTorch port of ``cbfssm_tpu.config``).

Model constructors accept the same plain dicts as the JAX package (same
keys, same defaults); this module normalizes them into a dataclass.
Option values are validated by :class:`cbfssm_tpu_torch.models.base.BaseSSM`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch


@dataclass
class ModelConfig:
    # dataset
    ds: Any = None  # dataset class or instance exposing dim_u / dim_y
    batch_size: int = 32
    shuffle: int = 10000
    # method
    dim_x: int = 4
    ind_pnt_num: int = 100
    samples: int = 50
    learning_rate: float = 0.01
    loss_factors: Sequence[float] = (10.0, 0.0)
    k_factor: float = 1.0
    recog_len: int = 50
    recog_model: str = "rnn"
    # variable init state
    zeta_pos: float = 2.0
    zeta_mean: float = 0.01
    zeta_var: float = 0.0001
    var_x: np.ndarray = None
    var_y: np.ndarray = None
    gp_var: float = 0.01
    gp_len: float = 1.0
    # voliro-specific
    loglik_factor: Sequence[float] = (20.0, 0.0, 200.0)
    n_beta: Sequence[float] = (10.0, 2.0, 10.0)
    l_beta: Sequence[float] = (1.0, 10.0, 10.0)
    var_z: np.ndarray = None
    filter_dt: Optional[float] = None
    # numerics: compute dtype and Cholesky jitter
    dtype: str = "float32"
    jitter: Optional[float] = None
    # GP predict in the time recursions: 'solve_free' runs the plain
    # torch ops, 'pallas' (the JAX package's name, kept so configs carry
    # over) runs the fused CUDA kernel of ops/fused_predict.py.
    gp_impl: str = "solve_free"
    # 'high' and 'highest' both run the GP matmuls in IEEE f32 (TF32
    # off); 'default' (one bf16 pass on the TPU) has no counterpart.
    gp_matmul_precision: str = "high"
    # lax.scan unroll factor in the JAX package; the port's Python loop
    # has no unroll, and the value only has to be a positive int.
    scan_unroll: int = 1
    # 'blocked' | 'sequential' | 'auto' recognition schedule
    backward_mode: str = "auto"
    # training-only options of the JAX package, accepted at their
    # defaults only (see BaseSSM)
    epochs_per_dispatch: Any = "auto"
    adjoint: str = "auto"
    skip_nonfinite_updates: bool = False
    # extra bag for forward-compat keys
    extra: dict = field(default_factory=dict)

    @property
    def dim_u(self) -> int:
        return self.ds.dim_u

    @property
    def dim_y(self) -> int:
        return self.ds.dim_y

    @classmethod
    def from_dict(cls, config: dict) -> "ModelConfig":
        known = {f for f in cls.__dataclass_fields__ if f != "extra"}
        kwargs = {k: v for k, v in config.items() if k in known}
        extra = {k: v for k, v in config.items() if k not in known}
        return cls(**kwargs, extra=extra)


def as_config(config) -> ModelConfig:
    if isinstance(config, ModelConfig):
        return config
    return ModelConfig.from_dict(dict(config))


def check_precision(dtype, device) -> None:
    """The config's promise for 'high' and 'highest' precision: a float32
    model on the card runs its matmuls in IEEE float32, so raise while
    cuBLAS may use TF32. The models call it at construction and at every
    entry point (the flag can change in between), the artifact loaders
    at load and at every call."""
    if torch.device(device).type != "cuda" or dtype != torch.float32:
        return
    # fp32_precision reflects both the legacy allow_tf32 flag and the
    # newer API (reading allow_tf32 raises once they are mixed)
    if torch.backends.cuda.matmul.fp32_precision == "tf32":
        raise ValueError(
            "torch.backends.cuda.matmul.allow_tf32 is on (also set by "
            "torch.set_float32_matmul_precision('high')): a float32 model on "
            "the GPU runs its matmuls in IEEE float32; set it to False")


def check_epochs_per_dispatch(epd) -> None:
    """Raise unless ``epd`` is 'auto' or an integer, the values the
    trainers' ``resolve_epochs_per_dispatch`` reads."""
    if isinstance(epd, str) and epd == "auto":
        return
    if isinstance(epd, (bool, np.bool_)) or not isinstance(epd, (int, np.integer)):
        raise ValueError("epochs_per_dispatch (fused multi-epoch dispatch, ROADMAP A4.1) must "
                         f"be 'auto' or an integer, got {epd!r}")
