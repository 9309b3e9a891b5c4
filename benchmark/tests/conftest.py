"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``).

Tests that need the card carry the ``cuda`` marker and ask for the
``cuda`` fixture, which skips them where there is none; the decision is
made when a test runs, never at import.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA GPU; skipped without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return "cuda"
