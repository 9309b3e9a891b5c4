"""Training layer of the port: the Adam loop, its checkpoints, and the
lane-batched multi-seed and sweep trainers."""

from cbfssm_tpu_torch.training.multiseed import MultiSeedTrainer, SeedView  # noqa: F401
from cbfssm_tpu_torch.training.sweep import SweepTrainer, SweptModel  # noqa: F401
from cbfssm_tpu_torch.training.trainer import Trainer  # noqa: F401
