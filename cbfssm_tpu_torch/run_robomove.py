"""RoboMove with the two-phase entropy curriculum (port of
``run/run_robomove.py``): phase 0 trains without the entropy term,
phase 1 retrains from the phase-0 checkpoint with entropy weight 2.

    python -m cbfssm_tpu_torch.run_robomove            # on the GPU
"""

import numpy as np

from cbfssm_tpu_torch.data import RoboMove
from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.outputs import OutputsRoboMove
from cbfssm_tpu_torch.training import Trainer


def model_config(phase: int, overrides=None) -> dict:
    """The RoboMove config of curriculum ``phase`` (0: no entropy term,
    1: entropy weight 2), with ``overrides`` applied."""
    dim_x = 4
    config = {
        "ds": RoboMove,
        "batch_size": 32,
        "shuffle": 10000,
        "dim_x": dim_x,
        "ind_pnt_num": 100,
        "samples": 50,
        "learning_rate": 0.01,
        "loss_factors": np.asarray([20.0, 2.0 * (phase == 1)]),
        "k_factor": 1.0,
        "recog_len": 50,
        "zeta_pos": 2.0,
        "zeta_mean": 0.1**2,
        "zeta_var": 0.01**2,
        "var_x": np.asarray([0.1**2] * dim_x),
        "var_y": np.asarray([1.0**2] * dim_x),
        "gp_var": 0.1**2,
        "gp_len": 1.0,
    }
    config.update(overrides or {})
    return config


def main(root="run_output/robomove", epochs=100, data_dir=None, config_overrides=None,
         seq_len=300, seq_stride=50, device="cuda"):
    """The defaults reproduce the reference curriculum; the keyword
    overrides let tests run the whole flow on fixtures (``device="cpu"``
    for the CPU)."""
    for phase in range(2):
        outputs = OutputsRoboMove(root)
        ds = RoboMove(seq_len, seq_stride, data_dir=data_dir)
        outputs.set_ds(ds)
        model = CBFSSM(model_config(phase, config_overrides), device=device)
        outputs.set_model(model, root)
        trainer = Trainer(model, root)
        trainer.train(ds, epochs, retrain=phase == 1)
        outputs.set_trainer(trainer)
        outputs.create_all()


if __name__ == "__main__":
    main()
