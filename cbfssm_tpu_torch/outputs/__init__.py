"""Evaluation artifacts of the port (plots, ``.mat`` files, MSE,
calibration, parameter dump). Importing it loads no matplotlib."""

from cbfssm_tpu_torch.outputs.outputs import Outputs  # noqa: F401
from cbfssm_tpu_torch.outputs.outputs_robomove import OutputsRoboMove  # noqa: F401
