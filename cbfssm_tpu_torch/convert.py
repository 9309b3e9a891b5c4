"""Parameters of the JAX package, as numpy arrays, into the port and
back.

The JAX package's ``CBFSSMParams`` has the leaves ``gp_f`` / ``gp_b``
{``z``, ``mean``, ``var_unc``, ``kern_var_unc``, ``kern_len_unc``},
``var_x_unc`` and ``var_y_unc``. A caller flattens that pytree to a
nested dict of numpy arrays (``{"gp_f": {"z": ..., ...}, ...}``) and
passes it here; nothing of JAX is imported. Checkpoints of the two
packages are not interchangeable (orbax against ``torch.save``): weights
cross over through these functions.
"""

from __future__ import annotations

import numpy as np
import torch

from cbfssm_tpu_torch.models.cbfssm import CBFSSMParams
from cbfssm_tpu_torch.ops.gp import SparseGPParams

GP_LEAVES = ("z", "mean", "var_unc", "kern_var_unc", "kern_len_unc")


def cbfssm_params_from_numpy(tree: dict, device="cuda", dtype=torch.float64) -> CBFSSMParams:
    """``CBFSSMParams`` on ``device`` (the card unless the caller asks
    for ``"cpu"``) in ``dtype`` from a nested dict of numpy arrays with
    the JAX package's leaf names."""

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def gp_params(sub):
        missing = [k for k in GP_LEAVES if k not in sub]
        if missing:
            raise KeyError(f"GP parameters lack leaves {missing}")
        return SparseGPParams(*(tensor(sub[k]) for k in GP_LEAVES))

    return CBFSSMParams(
        gp_f=gp_params(tree["gp_f"]),
        gp_b=gp_params(tree["gp_b"]),
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
