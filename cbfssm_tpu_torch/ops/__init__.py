"""Math core of the port: positivity transforms, RBF kernel, Cholesky,
sparse GP, closed-form Gaussian quantities, and the fused GP predict
(CUDA kernel + plain torch version)."""

from cbfssm_tpu_torch.ops import transforms  # noqa: F401
from cbfssm_tpu_torch.ops import kernels  # noqa: F401
from cbfssm_tpu_torch.ops import linalg  # noqa: F401
from cbfssm_tpu_torch.ops import distributions  # noqa: F401
from cbfssm_tpu_torch.ops import fused_predict  # noqa: F401
from cbfssm_tpu_torch.ops import gp  # noqa: F401
