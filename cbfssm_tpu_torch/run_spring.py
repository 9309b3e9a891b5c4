"""SpringNonlinear benchmark run (port of ``run/run_spring.py``): the
small-scale hyperparameter scheme on the nonlinear spring-damper data.

    python -m cbfssm_tpu_torch.run_spring [iterations]    # on the GPU

``spring_nonlinear.mat`` ships in the package's data directory; make a
new one with ``python -m cbfssm_tpu_torch.create_datasets.create_spring_nonlinear``.
"""

import math
import sys

import numpy as np

from cbfssm_tpu_torch.data import SpringNonlinear
from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.outputs.summary import serial_reproduction, vmapped_reproduction

root_dir = "run_output/spring"
iterations = 5  # overridable from the command line (see __main__)
seq_len = 50
seq_stride = 1
dim_x = 4
model_config = {
    "ds": SpringNonlinear,
    "batch_size": 10,
    "shuffle": 10000,
    "dim_x": dim_x,
    "ind_pnt_num": 20,
    "samples": 50,
    "learning_rate": 0.1,
    "loss_factors": np.asarray([0.5, 0.0]),
    "k_factor": 50.0,
    "recog_len": 16,
    "zeta_pos": 2.0,
    "zeta_mean": 0.05**2,
    "zeta_var": 0.01**2,
    "var_x": np.asarray([0.002**2] * dim_x),
    "var_y": np.asarray([1.0**2] * dim_x),
    "gp_var": 0.5**2,
    "gp_len": 2.0,
}
train_iterations = 30000


def main(
    root=root_dir,
    iterations=iterations,
    train_iterations=train_iterations,
    data_dir=None,
    config_overrides=None,
    seq_len=seq_len,
    seq_stride=seq_stride,
    vmap_seeds=False,
    device="cuda",
):
    """Each iteration trains for ``ceil(train_iterations / windows)``
    epochs (``device="cpu"`` for the CPU). ``vmap_seeds=True`` trains
    the ``iterations`` seeds as one lane-batched program
    (``vmapped_reproduction``; the same artifact layout)."""
    config = dict(model_config, **(config_overrides or {}))
    if vmap_seeds:
        ds = SpringNonlinear(seq_len, seq_stride, data_dir=data_dir)
        epochs = math.ceil(train_iterations / ds.train_in_batch.shape[0])
        return vmapped_reproduction(CBFSSM(config, device=device), ds, root, iterations,
                                    epochs, metrics_path=root + "/metrics.jsonl")
    return serial_reproduction(
        lambda: CBFSSM(config, device=device),
        lambda: SpringNonlinear(seq_len, seq_stride, data_dir=data_dir), root, iterations,
        lambda ds: math.ceil(train_iterations / ds.train_in_batch.shape[0]), metrics=True,
    )


if __name__ == "__main__":
    # argv is read only when run as a script
    main(iterations=int(sys.argv[1]) if len(sys.argv) > 1 else iterations)
