"""Parameters of the JAX package, as numpy arrays, into the port and
back.

The JAX package's ``CBFSSMParams`` has the leaves ``gp_f`` / ``gp_b``
{``z``, ``mean``, ``var_unc``, ``kern_var_unc``, ``kern_len_unc``},
``var_x_unc`` and ``var_y_unc``; ``CBFSSMHALFParams`` and
``PRSSMParams`` have ``gp_f``, ``var_x_unc``, ``var_y_unc`` and
``recog``, the flax recognition tree (``{}`` for 'output');
``VoliroParams`` has ``gp_f``, ``gp_b``, ``var_x_unc``, ``var_y_unc`` and
``var_z_unc``. A caller
flattens that pytree to a nested dict of numpy arrays (``{"gp_f": {"z":
..., ...}, ...}``) and passes it here; nothing of JAX is imported.

The flax trees map onto the port's recognition leaves
(``models/recognition.py``) as follows. GRU, ``{"params": {"GRUCell_0":
{"ir", "iz", "in": kernel [d, 16] + bias; "hr", "hz": kernel [16, 16];
"hn": kernel + bias}, "Dense_0": kernel [16, dim_x] + bias}}``:
``cell.weight_ih = cat(ir, iz, in).kernel.T``, ``cell.bias_ih =
cat(ir, iz, in).bias``, ``cell.weight_hh = cat(hr, hz, hn).kernel.T``,
``cell.bias_hn = hn.bias`` (torch's gate order is r, z, n). Conv,
``{"params": {"Conv_0": kernel [3, d, 5] + bias, "Dense_0": kernel [35,
dim_x] + bias}}``: ``conv.weight`` is the kernel as ``[5, d, 3]``. A
Dense kernel is the transpose of ``readout.weight``. Checkpoints of the two
packages are not interchangeable (orbax against ``torch.save``): weights
cross over through these functions.

Stacked trees (multi-seed and sweep training). Every function here also
takes a tree whose arrays carry a leading lane axis, as
``jax.vmap(model.init)`` gives it, and gives the port's stacked params
(every leaf ``[L, ...]``, the layout of
``cbfssm_tpu_torch.training.MultiSeedTrainer``), and back: the
recognition transposes act on the last axes. :func:`lane` takes one
lane of such a tree and :func:`stack` stacks single trees.
"""

from __future__ import annotations

import numpy as np
import torch

from cbfssm_tpu_torch.models.cbfssm import CBFSSMParams
from cbfssm_tpu_torch.models.cbfssmhalf import CBFSSMHALFParams
from cbfssm_tpu_torch.models.prssm import PRSSMParams
from cbfssm_tpu_torch.models.voliro import VoliroParams
from cbfssm_tpu_torch.ops.gp import SparseGPParams

GP_LEAVES = ("z", "mean", "var_unc", "kern_var_unc", "kern_len_unc")
GRU_GATES = ("r", "z", "n")  # torch's order of the gates in a GRU weight


def _tensor_fn(device, dtype):
    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return tensor


def _gp_params(sub, tensor) -> SparseGPParams:
    missing = [k for k in GP_LEAVES if k not in sub]
    if missing:
        raise KeyError(f"GP parameters lack leaves {missing}")
    return SparseGPParams(*(tensor(sub[k]) for k in GP_LEAVES))


def cbfssm_params_from_numpy(tree: dict, device="cuda", dtype=torch.float64) -> CBFSSMParams:
    """``CBFSSMParams`` on ``device`` (the card unless the caller asks
    for ``"cpu"``) in ``dtype`` from a nested dict of numpy arrays with
    the JAX package's leaf names."""
    tensor = _tensor_fn(device, dtype)
    return CBFSSMParams(
        gp_f=_gp_params(tree["gp_f"], tensor),
        gp_b=_gp_params(tree["gp_b"], tensor),
        var_x_unc=tensor(tree["var_x_unc"]),
        var_y_unc=tensor(tree["var_y_unc"]),
    )


def cbfssm_params_to_numpy(params: CBFSSMParams) -> dict:
    """The inverse of :func:`cbfssm_params_from_numpy`: the nested dict
    of numpy arrays (host copies, in the tensors' dtype)."""

    def array(t):
        return t.detach().cpu().numpy()

    return {
        "gp_f": {k: array(getattr(params.gp_f, k)) for k in GP_LEAVES},
        "gp_b": {k: array(getattr(params.gp_b, k)) for k in GP_LEAVES},
        "var_x_unc": array(params.var_x_unc),
        "var_y_unc": array(params.var_y_unc),
    }


def _leaf(tree: dict, *path):
    """``tree[path[0]][path[1]]...``; a missing leaf raises a KeyError
    that names its path."""
    node = tree
    for i, key in enumerate(path):
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f"recognition parameters lack leaf {'/'.join(path[:i + 1])}")
        node = node[key]
    return np.asarray(node)


def _t(a):
    """The transpose of the last two axes."""
    return np.swapaxes(a, -1, -2)


def _recognition_from_flax(recog: dict, tensor) -> dict:
    """The port's recognition leaves from a flax tree ({} for 'output')."""
    if not recog:
        return {}
    params = recog.get("params", {})
    if "GRUCell_0" in params:
        def gates(kind, leaf):
            return [_leaf(recog, "params", "GRUCell_0", kind + g, leaf) for g in GRU_GATES]

        leaves = {
            "cell.weight_ih": _t(np.concatenate(gates("i", "kernel"), axis=-1)),
            "cell.bias_ih": np.concatenate(gates("i", "bias"), axis=-1),
            "cell.weight_hh": _t(np.concatenate(gates("h", "kernel"), axis=-1)),
            "cell.bias_hn": _leaf(recog, "params", "GRUCell_0", "hn", "bias"),
        }
    elif "Conv_0" in params:
        leaves = {
            # [3, d, 5] -> [5, d, 3] (behind any lane axis)
            "conv.weight": np.swapaxes(_leaf(recog, "params", "Conv_0", "kernel"), -1, -3),
            "conv.bias": _leaf(recog, "params", "Conv_0", "bias"),
        }
    else:
        raise KeyError("recognition parameters lack leaf params/GRUCell_0 or params/Conv_0")
    leaves["readout.weight"] = _t(_leaf(recog, "params", "Dense_0", "kernel"))
    leaves["readout.bias"] = _leaf(recog, "params", "Dense_0", "bias")
    return {k: tensor(np.ascontiguousarray(v)) for k, v in leaves.items()}


def _recognition_to_flax(recog: dict) -> dict:
    """The inverse of :func:`_recognition_from_flax`."""
    if not recog:
        return {}
    a = {k: v.detach().cpu().numpy() for k, v in recog.items()}
    if "cell.weight_ih" in a:
        cell = {}
        h = a["cell.bias_hn"].shape[-1]
        for j, g in enumerate(GRU_GATES):
            rows = slice(j * h, (j + 1) * h)
            cell["i" + g] = {"kernel": _t(a["cell.weight_ih"][..., rows, :]).copy(),
                             "bias": a["cell.bias_ih"][..., rows].copy()}
            cell["h" + g] = {"kernel": _t(a["cell.weight_hh"][..., rows, :]).copy()}
        cell["hn"]["bias"] = a["cell.bias_hn"]
        params = {"GRUCell_0": cell}
    else:
        params = {"Conv_0": {"kernel": np.swapaxes(a["conv.weight"], -1, -3).copy(),
                             "bias": a["conv.bias"]}}
    params["Dense_0"] = {"kernel": _t(a["readout.weight"]).copy(), "bias": a["readout.bias"]}
    return {"params": params}


def _recognition_params_from_numpy(cls, tree, device, dtype):
    tensor = _tensor_fn(device, dtype)
    return cls(
        gp_f=_gp_params(tree["gp_f"], tensor),
        var_x_unc=tensor(tree["var_x_unc"]),
        var_y_unc=tensor(tree["var_y_unc"]),
        recog=_recognition_from_flax(tree["recog"], tensor),
    )


def cbfssmhalf_params_from_numpy(tree: dict, device="cuda",
                                 dtype=torch.float64) -> CBFSSMHALFParams:
    """``CBFSSMHALFParams`` on ``device`` in ``dtype`` from the JAX
    ``CBFSSMHALFParams`` as a nested dict of numpy arrays, its ``recog``
    the flax tree."""
    return _recognition_params_from_numpy(CBFSSMHALFParams, tree, device, dtype)


def prssm_params_from_numpy(tree: dict, device="cuda", dtype=torch.float64) -> PRSSMParams:
    """``PRSSMParams`` on ``device`` in ``dtype`` from the JAX
    ``PRSSMParams`` as a nested dict of numpy arrays, its ``recog`` the
    flax tree."""
    return _recognition_params_from_numpy(PRSSMParams, tree, device, dtype)


def cbfssmhalf_params_to_numpy(params) -> dict:
    """The inverse of :func:`cbfssmhalf_params_from_numpy` (and, as
    ``prssm_params_to_numpy``, of :func:`prssm_params_from_numpy`): the
    nested dict of numpy arrays, ``recog`` in flax's layout."""
    return {
        "gp_f": {k: getattr(params.gp_f, k).detach().cpu().numpy() for k in GP_LEAVES},
        "var_x_unc": params.var_x_unc.detach().cpu().numpy(),
        "var_y_unc": params.var_y_unc.detach().cpu().numpy(),
        "recog": _recognition_to_flax(params.recog),
    }


prssm_params_to_numpy = cbfssmhalf_params_to_numpy


VOLIRO_NOISE_LEAVES = ("var_x_unc", "var_y_unc", "var_z_unc")


def voliro_params_from_numpy(tree: dict, device="cuda", dtype=torch.float64) -> VoliroParams:
    """``VoliroParams`` on ``device`` in ``dtype`` from the JAX
    ``VoliroParams`` as a nested dict of numpy arrays. A missing leaf
    raises a ``KeyError`` that names it."""
    gps = ("gp_f", "gp_b")
    missing = [k for k in (*gps, *VOLIRO_NOISE_LEAVES) if k not in tree] + [
        f"{g}/{k}" for g in gps if g in tree for k in GP_LEAVES if k not in tree[g]]
    if missing:
        raise KeyError(f"Voliro parameters lack leaves {missing}")
    tensor = _tensor_fn(device, dtype)
    return VoliroParams(*(_gp_params(tree[g], tensor) for g in gps),
                        *(tensor(tree[k]) for k in VOLIRO_NOISE_LEAVES))


def voliro_params_to_numpy(params: VoliroParams) -> dict:
    """The inverse of :func:`voliro_params_from_numpy`."""

    def array(t):
        return t.detach().cpu().numpy()

    return {
        "gp_f": {k: array(getattr(params.gp_f, k)) for k in GP_LEAVES},
        "gp_b": {k: array(getattr(params.gp_b, k)) for k in GP_LEAVES},
        **{k: array(getattr(params, k)) for k in VOLIRO_NOISE_LEAVES},
    }


def lane(tree, i: int):
    """Lane ``i`` of a stacked tree (a nested dict of arrays that all
    carry a leading lane axis): the same nested dict of each array's
    lane ``i``."""
    if isinstance(tree, dict):
        return {k: lane(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def stack(trees):
    """The stacked tree of single trees of one structure: each array
    with a new leading lane axis (the inverse of :func:`lane`)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])
