"""Small-scale system-identification benchmarks (port of
``run/run_smallscale.py``): 5 datasets x 5 iterations with per-dataset
(lambda_1, k_factor).

    python -m cbfssm_tpu_torch.run_smallscale [task]    # on the GPU

The raw files (``actuator.mat``, ``ballbeam.dat``, ``drive.mat``,
``dryer.dat``, ``gas_furnace.csv``) are read from ``data_dir`` (by
default the package's data directory).
"""

import math
import sys

import numpy as np

from cbfssm_tpu_torch.data import Actuator, Ballbeam, Drive, Dryer, Furnace
from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.outputs.summary import serial_reproduction, vmapped_reproduction

# Choose Tasks: (dataset, name, lambda_1, k_factor)
datasets = [
    (Actuator, "actuator", 0.5, 100),
    (Ballbeam, "ballbeam", 0.05, 10),
    (Drive, "drive", 0.5, 50),
    (Dryer, "dryer", 0.15, 100),
    (Furnace, "furnace", 0.15, 100),
]
tasks = range(len(datasets))  # the command line can select one task


def model_config(task_nr: int, dim_x: int = 4) -> dict:
    """The reference's hyperparameter dict for one task, with its
    (lambda_1, k_factor)."""
    return {
        "ds": datasets[task_nr][0],
        "batch_size": 10,
        "shuffle": 10000,
        "dim_x": dim_x,
        "ind_pnt_num": 20,
        "samples": 50,
        "learning_rate": 0.1,
        "loss_factors": np.asarray([1.0, 0.0]) * datasets[task_nr][2],
        "k_factor": datasets[task_nr][3],
        "recog_len": 16,
        "zeta_pos": 2.0,
        "zeta_mean": 0.05**2,
        "zeta_var": 0.01**2,
        "var_x": np.asarray([0.002**2] * dim_x),
        "var_y": np.asarray([1.0**2] * dim_x),
        "gp_var": 0.5**2,
        "gp_len": 2.0,
    }


def main(
    task_list=None,
    root="run_output/smallscale",
    iterations=5,
    train_iterations=30000,
    data_dir=None,
    config_overrides=None,
    seq_len=50,
    seq_stride=1,
    vmap_seeds=False,
    device="cuda",
):
    """The defaults reproduce the reference experiment; the keyword
    overrides let tests run the whole flow on fixtures (``device="cpu"``
    for the CPU). ``vmap_seeds=True`` trains each task's ``iterations``
    seeds as one lane-batched program (``vmapped_reproduction``; the same
    artifact layout)."""
    for task_nr in task_list if task_list is not None else tasks:
        ds_cls, name = datasets[task_nr][:2]
        config = model_config(task_nr)
        config.update(config_overrides or {})
        if vmap_seeds:
            ds = ds_cls(seq_len, seq_stride, data_dir=data_dir)
            epochs = math.ceil(train_iterations / ds.train_in_batch.shape[0])
            vmapped_reproduction(CBFSSM(config, device=device), ds, root + "/" + name,
                                 iterations, epochs)
            continue
        serial_reproduction(
            lambda config=config: CBFSSM(config, device=device),
            lambda ds_cls=ds_cls: ds_cls(seq_len, seq_stride, data_dir=data_dir),
            root + "/" + name, iterations,
            lambda ds: math.ceil(train_iterations / ds.train_in_batch.shape[0]),
        )


if __name__ == "__main__":
    # argv is read only when run as a script
    main(task_list=[int(sys.argv[1])] if len(sys.argv) > 1 else None)
