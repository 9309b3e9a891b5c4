"""The port's ``trace`` and ``debug_nans`` (``utils/profiling.py``, the
counterparts of the JAX package's ``jax.profiler`` trace and
``jax_debug_nans`` switch) on the CPU."""

import glob
import json

import pytest
import torch

from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.utils.profiling import debug_nans, trace
from tests.test_trainer import SmokeDS, smoke_config


def test_trace_writes_a_trace_file_of_the_block(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.matmul(torch.ones(4, 4), torch.ones(4, 4))
    assert any(e.name == "aten::matmul" for e in prof.events())
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names


def test_debug_nans_raises_inside_the_block_only():
    x = torch.tensor([1.0, -1.0])
    with pytest.raises(FloatingPointError, match="sqrt"):
        with debug_nans():
            torch.sqrt(x)
    assert torch.isnan(torch.sqrt(x)).any()  # outside the block: no check
    with debug_nans():
        torch.sqrt(torch.abs(x))  # no NaN, no error


def test_debug_nans_raises_in_the_backward():
    """The forward is finite (0 * sqrt(0)); its gradient is 0 * inf."""
    x = torch.tensor([0.0], requires_grad=True)
    with debug_nans():
        y = torch.sum(torch.sqrt(x) * 0.0)
        with pytest.raises(FloatingPointError):
            y.backward()


def test_debug_nans_restores_the_previous_state():
    before = torch.is_anomaly_enabled()
    x = torch.tensor([-1.0])
    with debug_nans():
        assert torch.is_anomaly_enabled()
        with debug_nans(False):  # off inside an enclosing block
            assert torch.isnan(torch.sqrt(x)).all()
        with pytest.raises(FloatingPointError):
            torch.sqrt(x)
    assert torch.is_anomaly_enabled() == before
    assert torch.isnan(torch.sqrt(x)).all()


def test_debug_nans_passes_a_finite_training_step():
    model = CBFSSM(smoke_config(), device="cpu")
    ds = SmokeDS()
    params = model.init(torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_(True) for t in params.tensors()]
    with debug_nans():
        loss, _ = model.loss(params.with_tensors(leaves), ds.train_in_batch[:2],
                             ds.train_out_batch[:2], torch.Generator().manual_seed(1))
        loss.backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)
