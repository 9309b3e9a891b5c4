"""Offline generators of the synthetic datasets (port of the repository's
``create_datasets/`` scripts), each run as
``python -m cbfssm_tpu_torch.create_datasets.<name>``."""
