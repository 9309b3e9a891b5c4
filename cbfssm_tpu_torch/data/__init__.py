"""Dataset layer of the port: numpy host pipeline producing
[experiments, time, dim] arrays and windowed sequence batches."""

from cbfssm_tpu_torch.data.base import BaseDS  # noqa: F401
from cbfssm_tpu_torch.data.ds_manager import DSManager  # noqa: F401
from cbfssm_tpu_torch.data.datasets import (  # noqa: F401
    Actuator,
    Ballbeam,
    Drive,
    Dryer,
    DSManagerDS,
    Furnace,
    RoboMove,
    RoboMoveSimple,
    Sarcos,
    SpringNonlinear,
    SystemIdDS,
    VoliroFlipDS,
    VoliroTiltDS,
)
