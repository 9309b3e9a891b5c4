"""Evaluation artifacts of the port (plots, ``.mat`` files, MSE,
calibration, parameter dump, multi-run summary). Importing it loads no
matplotlib."""

from cbfssm_tpu_torch.outputs.outputs import Outputs  # noqa: F401
from cbfssm_tpu_torch.outputs.outputs_robomove import OutputsRoboMove  # noqa: F401
from cbfssm_tpu_torch.outputs.outputs_voliro import OutputsVoliro  # noqa: F401
from cbfssm_tpu_torch.outputs.summary import OutputSummary  # noqa: F401
