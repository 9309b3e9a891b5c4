"""Voliro flip-log experiment (port of ``run/run_voliro.py``).

    python -m cbfssm_tpu_torch.run_voliro            # on the GPU

The flight logs ``voliro_tilt.mat`` and ``voliro_flip.mat`` are read from
``data_dir`` (by default the package's data directory).
"""

import numpy as np

from cbfssm_tpu_torch.data import VoliroFlipDS
from cbfssm_tpu_torch.models import Voliro
from cbfssm_tpu_torch.outputs import OutputsVoliro
from cbfssm_tpu_torch.training import Trainer

root_dir = "run_output/voliro"
seq_len = 64
seq_stride = 50
model_config = {
    "ds": VoliroFlipDS,
    "batch_size": 16,
    "shuffle": 10000,
    "ind_pnt_num": 20,
    "samples": 20,
    "learning_rate": 0.01,
    "loglik_factor": np.asarray([20.0, 0.0, 0.2 * 20 * 50]),
    "n_beta": [10.0, 2.0, 10.0],
    "l_beta": [1.0, 10.0, 10.0],
    "zeta_pos": 2.0,
    "zeta_mean": 0.05**2,
    "zeta_var": 0.01**2,
    "gp_var": 0.5**2,
    "gp_len": 5.0,
    "var_x": np.asarray(
        [0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2]
    )
    ** 2,
    "var_y": np.asarray(
        [0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2]
    )
    ** 2,
    "var_z": np.asarray([0.02] * 6),
}
epochs = 2000


def main(
    root=root_dir,
    epochs=epochs,
    data_dir=None,
    config_overrides=None,
    seq_len=seq_len,
    seq_stride=seq_stride,
    device="cuda",
):
    """The defaults reproduce the reference experiment; the keyword
    overrides let tests run the whole flow on synthetic flight logs
    (``device="cpu"`` for the CPU)."""
    config = dict(model_config, **(config_overrides or {}))
    outputs = OutputsVoliro(root)
    ds = VoliroFlipDS(seq_len, seq_stride, data_dir=data_dir)
    outputs.set_ds(ds)
    model = Voliro(config, device=device)
    outputs.set_model(model, root)
    trainer = Trainer(model, root, metrics_path=root + "/metrics.jsonl")
    trainer.train(ds, epochs)
    outputs.set_trainer(trainer)
    outputs.create_all()
    return outputs


if __name__ == "__main__":
    main()
