"""Initial-state recognition networks (port of
``cbfssm_tpu/models/recognition.py``): map the first ``recog_len`` steps
of the (control, observation) sequence, ``[B, recog_len, du + dy]``, to
an initial latent state x_0 ``[B, dim_x]``.

The JAX package keeps a flax module and its params apart; so does the
port. A net is an ``nn.Module`` built on the ``meta`` device, so it
holds no weights, and a model's params carry the net's leaves (a dict of
tensors, in the net's ``LEAVES`` order). :func:`apply` runs the module
on those leaves through ``torch.func.functional_call``, so gradients
reach them as they reach every other parameter leaf. :func:`init_leaves`
draws them with the distributions flax uses (truncated-normal LeCun
kernels, orthogonal recurrent kernels, zero biases).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

HIDDEN = 16  # GRU carry width (reference prssm.py:159-169)
CONV_LEN = 16  # the conv net's flatten is sized for this recog_len


class GRURecognition(nn.Module):
    """``nn.GRUCell(d_in, 16)`` stepped over the *reversed* prefix from a
    zero carry, then ``nn.Linear(16, dim_x)`` on the final carry (the
    flax ``GRUCell`` under ``nn.RNN``, then ``Dense``).

    flax puts no bias on the recurrent r and z gates: the first 2 x 16
    entries of ``cell.bias_hh`` are held at zero, and its trainable leaf
    is the last 16 (``cell.bias_hn``). torch's gate order is r, z, n.

    The cell holds the parameters; the step is written out in torch ops
    in ``aten::gru_cell``'s order (its input projection taken for all
    steps at once), because ``gru_cell`` has no batching rule for
    ``torch.func.vmap`` and would loop over the lanes of a multi-seed
    program. The matmuls run on cuBLAS, which the models' TF32 check
    covers (``nn.GRU`` would run cuDNN)."""

    LEAVES = ("cell.weight_ih", "cell.bias_ih", "cell.weight_hh", "cell.bias_hn",
              "readout.weight", "readout.bias")

    def __init__(self, d_in: int, dim_x: int, dtype=torch.float32, device="meta"):
        super().__init__()
        self.cell = nn.GRUCell(d_in, HIDDEN, dtype=dtype, device=device)
        self.readout = nn.Linear(HIDDEN, dim_x, dtype=dtype, device=device)

    def forward(self, uy):  # [B, T, d] -> [B, dim_x]
        cell = self.cell
        gates_in = F.linear(uy, cell.weight_ih, cell.bias_ih)  # [B, T, 3 x 16]
        h = uy.new_zeros((uy.shape[0], HIDDEN))
        for t in range(uy.shape[1] - 1, -1, -1):
            i_r, i_z, i_n = gates_in[:, t].chunk(3, dim=-1)
            h_r, h_z, h_n = F.linear(h, cell.weight_hh, cell.bias_hh).chunk(3, dim=-1)
            reset = torch.sigmoid(h_r + i_r)
            update = torch.sigmoid(h_z + i_z)
            new = torch.tanh(i_n + h_n * reset)
            h = (h - new) * update + new
        return self.readout(h)

    def module_tensors(self, leaves: dict) -> dict:
        """The module's parameters, by name, built from the leaves."""
        bias_hn = leaves["cell.bias_hn"]
        named = {k: v for k, v in leaves.items() if k != "cell.bias_hn"}
        named["cell.bias_hh"] = torch.cat((bias_hn.new_zeros(2 * HIDDEN), bias_hn))
        return named


def _ieee_conv(x):
    """cuDNN with TF32 off around a conv on the card (cuDNN's TF32 flag
    is on by default)."""
    if x.device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class ConvRecognition(nn.Module):
    """``nn.Conv1d(d_in, 5, 3)`` (VALID), ReLU, ``max_pool1d(2, 2)``,
    flatten, ``nn.Linear(35, dim_x)``. The reference's hardcoded 35-unit
    flatten (7 pooled steps x 5 filters, prssm.py:151-153) requires
    recog_len == 16. flax is channels-last and flattens in (time,
    channel) order, so the pooled ``[B, 5, 7]`` is transposed first."""

    LEAVES = ("conv.weight", "conv.bias", "readout.weight", "readout.bias")

    def __init__(self, d_in: int, dim_x: int, dtype=torch.float32, device="meta"):
        super().__init__()
        self.conv = nn.Conv1d(d_in, 5, 3, dtype=dtype, device=device)
        self.readout = nn.Linear(35, dim_x, dtype=dtype, device=device)

    def forward(self, uy):  # [B, 16, d] -> [B, dim_x]
        if uy.shape[1] != CONV_LEN:
            raise ValueError(
                "ConvRecognition requires recog_len == 16 (flatten is sized "
                "for 7 pooled steps x 5 filters = 35 units)"
            )
        with _ieee_conv(uy):
            h = self.conv(uy.transpose(1, 2))
        h = F.max_pool1d(F.relu(h), 2, 2)
        return self.readout(h.transpose(1, 2).reshape(uy.shape[0], 35))

    def module_tensors(self, leaves: dict) -> dict:
        return dict(leaves)


def output_recognition(y, dim_x):
    """x_0 = first observation zero-padded to dim_x (reference
    prssm.py:140-144). y: [B, T, dy] -> [B, dim_x]."""
    return F.pad(y[:, 0, :], (0, dim_x - y.shape[-1]))


def make_recognition(kind: str, d_in: int, dim_x: int, recog_len: int, dtype):
    """The recognition module (on the meta device), or None for the
    parameter-free 'output' kind."""
    if kind == "output":
        return None
    if kind == "rnn":
        return GRURecognition(d_in, dim_x, dtype)
    if kind == "conv":
        if recog_len != CONV_LEN:
            raise ValueError(
                f"ConvRecognition requires recog_len == 16, got {recog_len} (flatten is "
                "sized for 7 pooled steps x 5 filters = 35 units)"
            )
        return ConvRecognition(d_in, dim_x, dtype)
    raise ValueError(f"invalid recognition model: {kind!r}")


def apply(module, leaves: dict, uy):
    """Run ``module`` with the parameter leaves ``leaves`` on ``uy``."""
    return torch.func.functional_call(module, module.module_tensors(leaves), (uy,))


def _lecun_normal(generator, shape, fan_in, dtype, device):
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=dtype, device=device)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_leaves(module, generator: torch.Generator, dtype, device) -> dict:
    """Fresh leaves for ``module`` (empty for None), drawn from
    ``generator`` on ``device`` as flax initializes the same net."""
    if module is None:
        return {}
    kw = dict(dtype=dtype, device=device)
    if isinstance(module, GRURecognition):
        d_in = module.cell.input_size
        recurrent = []
        for _ in range(3):  # hr, hz, hn: one orthogonal kernel each
            recurrent.append(nn.init.orthogonal_(torch.empty((HIDDEN, HIDDEN), **kw),
                                                 generator=generator))
        weights = {
            "cell.weight_ih": _lecun_normal(generator, (3 * HIDDEN, d_in), d_in, **kw),
            "cell.bias_ih": torch.zeros(3 * HIDDEN, **kw),
            "cell.weight_hh": torch.cat(recurrent),
            "cell.bias_hn": torch.zeros(HIDDEN, **kw),
        }
    else:
        d_in = module.conv.in_channels
        weights = {
            "conv.weight": _lecun_normal(generator, (5, d_in, 3), 3 * d_in, **kw),
            "conv.bias": torch.zeros(5, **kw),
        }
    dim_x, width = module.readout.out_features, module.readout.in_features
    weights["readout.weight"] = _lecun_normal(generator, (dim_x, width), width, **kw)
    weights["readout.bias"] = torch.zeros(dim_x, **kw)
    return {k: weights[k] for k in module.LEAVES}
