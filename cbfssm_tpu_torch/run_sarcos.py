"""Sarcos 7-DoF arm forward dynamics (port of ``run/run_sarcos.py``):
5 iterations, dim_x = 14, 100 inducing points.

    python -m cbfssm_tpu_torch.run_sarcos            # on the GPU

``sarcos_inv.mat`` is read from ``data_dir`` (by default the package's
data directory).
"""

import numpy as np

from cbfssm_tpu_torch.data import Sarcos
from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.outputs.summary import serial_reproduction, vmapped_reproduction

root_dir = "run_output/sarcos"
iterations = 5
seq_len = 250
seq_stride = 10
dim_x = 14
model_config = {
    "ds": Sarcos,
    "batch_size": 5,
    "shuffle": 10000,
    "dim_x": dim_x,
    "ind_pnt_num": 100,
    "samples": 20,
    "learning_rate": 0.05,
    "loss_factors": np.asarray([6.0, 0.0]),
    "k_factor": 50.0,
    "recog_len": 16,
    "zeta_pos": 2.0,
    "zeta_mean": 0.05**2,
    "zeta_var": 0.01**2,
    "var_x": np.asarray([0.002**2] * dim_x),
    "var_y": np.asarray([0.05**2] * dim_x),
    "gp_var": 0.5**2,
    "gp_len": 1.0,
}
epochs = 8

def main(
    root=root_dir,
    iterations=iterations,
    epochs=epochs,
    data_dir=None,
    config_overrides=None,
    seq_len=seq_len,
    seq_stride=seq_stride,
    vmap_seeds=False,
    device="cuda",
):
    """The defaults reproduce the reference experiment; the keyword
    overrides let tests run the whole flow on fixtures (``device="cpu"``
    for the CPU). ``vmap_seeds=True`` trains the ``iterations`` seeds as
    one lane-batched program (``vmapped_reproduction``; the same artifact
    layout)."""
    config = dict(model_config, **(config_overrides or {}))
    if vmap_seeds:
        ds = Sarcos(seq_len, seq_stride, data_dir=data_dir)
        return vmapped_reproduction(CBFSSM(config, device=device), ds, root, iterations, epochs)
    return serial_reproduction(lambda: CBFSSM(config, device=device),
                               lambda: Sarcos(seq_len, seq_stride, data_dir=data_dir), root,
                               iterations, lambda ds: epochs)


if __name__ == "__main__":
    main()
