"""SSM models of the port: ``CBFSSM``, ``CBFSSMHALF``, ``PRSSM`` and
``Voliro``, each with ``init(generator) -> params``, ``loss(params, u, y,
generator | noise=, condition, weights) -> (loss, aux)`` and
``predict(params, u, y, generator | noise=, condition)``, which returns a
``PredictOutput`` (a dict for ``Voliro``)."""

from cbfssm_tpu_torch.models.cbfssm import CBFSSM  # noqa: F401
from cbfssm_tpu_torch.models.cbfssmhalf import CBFSSMHALF  # noqa: F401
from cbfssm_tpu_torch.models.prssm import PRSSM  # noqa: F401
from cbfssm_tpu_torch.models.voliro import Voliro  # noqa: F401
