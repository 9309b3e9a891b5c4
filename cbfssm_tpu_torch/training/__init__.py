"""Training layer of the port: the Adam loop and its checkpoints."""

from cbfssm_tpu_torch.training.trainer import Trainer  # noqa: F401
