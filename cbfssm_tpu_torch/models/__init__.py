"""SSM models of the port. ``CBFSSM``: ``init(generator) -> params``,
``loss(params, u, y, generator | noise=, condition, weights) -> (loss,
aux)``, ``predict(params, u, y, generator | noise=, condition) ->
PredictOutput``."""

from cbfssm_tpu_torch.models.cbfssm import CBFSSM  # noqa: F401
