"""The port's serving layer on a tiny CBFSSM (CPU, float64): fixed-shape,
bucketed and micro-batched prediction; pad-row independence, chunking
above the top bucket, the recomputed mse, threaded requests and the
shape checks."""

import threading

import numpy as np
import pytest
import torch

from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.serving import (BucketedPredictor, CompiledPredictor, MicroBatcher,
                                      fold_seed)

T = 8


class TinyDS:
    dim_u = 2
    dim_y = 1


def tiny_config(gp_impl="pallas"):
    return {
        "ds": TinyDS, "dim_x": 3, "ind_pnt_num": 5, "samples": 3, "recog_len": 2,
        "loss_factors": np.asarray([0.7, 0.3]), "k_factor": 10.0,
        "var_x": np.asarray([0.01] * 3), "var_y": np.asarray([0.5] * 3),
        "gp_var": 0.25, "gp_len": 1.5, "dtype": "float64", "jitter": 1e-8,
        "gp_impl": gp_impl,
    }


@pytest.fixture(scope="module")
def served():
    model = CBFSSM(tiny_config(), device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, T, 2)), rng.normal(size=(n, T, 1))


def test_compiled_predictor_shapes_and_errors(served):
    model, params = served
    pred = CompiledPredictor(model, params, batch=2, seq_len=T)
    u, y = windows(2)
    out = pred(u, y)
    assert tuple(out.pred_mean.shape) == (2, T, 1) and tuple(out.internal_var.shape) == (2, T, 3)
    assert torch.equal(out.pred_mean, pred(u, y).pred_mean)  # same seed, same draws
    assert not torch.equal(out.pred_mean, pred(u, y, seed=5).pred_mean)
    with pytest.raises(ValueError, match="built for u"):
        pred(u[:1], y[:1])
    with pytest.raises(ValueError, match="built for y"):
        pred(u, np.zeros((2, T, 2)))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_bucketed_shapes_and_mse(served, n):
    model, params = served
    bp = BucketedPredictor(model, params, T, buckets=(1, 4))
    u, y = windows(n)
    out = bp(u, y)
    for name, dim in (("pred_mean", 1), ("pred_var", 1), ("internal_mean", 3), ("sde", 1)):
        assert getattr(out, name).shape == (n, T, dim)
        assert isinstance(getattr(out, name), np.ndarray)
    np.testing.assert_allclose(out.mse, np.mean((out.pred_mean - y) ** 2), rtol=1e-12)
    assert np.isfinite(out.pred_var).all() and (out.pred_var > 0).all()


def test_pad_rows_do_not_affect_real_rows(served):
    model, params = served
    bp = BucketedPredictor(model, params, T, buckets=(4,))
    u, y = windows(4)
    alone = bp(u[:3], y[:3])  # padded with one zero row
    u2, y2 = u.copy(), y.copy()
    u2[3] *= 50.0
    y2[3] += 7.0
    full = bp(u2, y2)
    for name in ("pred_mean", "pred_var", "internal_mean", "internal_var", "sde"):
        np.testing.assert_array_equal(getattr(alone, name), getattr(full, name)[:3])


def test_chunking_above_top_bucket(served):
    model, params = served
    bp = BucketedPredictor(model, params, T, buckets=(1, 2))
    u, y = windows(5)
    out = bp(u, y, seed=9)
    assert out.pred_mean.shape == (5, T, 1)
    # chunk c is the bucket predictor with generator seed fold_seed(9, c)
    for c, (lo, hi) in enumerate([(0, 2), (2, 4), (4, 5)]):
        part = bp._one_batch(u[lo:hi], y[lo:hi], fold_seed(9, c))
        np.testing.assert_array_equal(out.pred_mean[lo:hi], part.pred_mean)
    # and the chunks draw independently: identical windows differ across chunks
    same = bp(np.repeat(u[:1], 4, 0), np.repeat(y[:1], 4, 0))
    assert not np.array_equal(same.pred_mean[0], same.pred_mean[2])
    np.testing.assert_allclose(out.mse, np.mean((out.pred_mean - y) ** 2), rtol=1e-12)


def test_bucketed_rejects_bad_requests(served):
    model, params = served
    with pytest.raises(ValueError, match="bucket"):
        BucketedPredictor(model, params, T, buckets=())
    with pytest.raises(ValueError, match=">= 1"):
        BucketedPredictor(model, params, T, buckets=(0, 2))
    bp = BucketedPredictor(model, params, T, buckets=(2,))
    u, y = windows(2)
    with pytest.raises(ValueError, match="expected"):
        bp(u[:, :4], y[:, :4])
    with pytest.raises(ValueError, match="y must be"):
        bp(u, y[:1])
    with pytest.raises(ValueError, match="at least one"):
        bp(u[:0], y[:0])


def test_microbatcher_threaded_requests(served):
    model, params = served
    bp = BucketedPredictor(model, params, T, buckets=(1, 2, 4))
    u, y = windows(6, seed=4)
    results = [None] * 6
    with MicroBatcher(bp, max_batch=4, max_wait_ms=20.0, seed=3) as mb:
        def client(k):
            for i in range(k, 6, 3):
                results[i] = mb.submit(u[i], y[i]).result(timeout=120)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        stats = mb.stats()
    assert stats["requests"] == 6 and stats["errors"] == 0
    assert 2 <= stats["batches"] <= 6 and stats["max_batch_seen"] <= 4
    for i, out in enumerate(results):
        assert out.pred_mean.shape == (1, T, 1) and out.internal_var.shape == (1, T, 3)
        np.testing.assert_allclose(out.mse, np.mean((out.pred_mean[0] - y[i]) ** 2), rtol=1e-12)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(u[0], y[0])


def test_microbatcher_checks_and_sync_call(served):
    model, params = served
    bp = BucketedPredictor(model, params, T, buckets=(1,))
    u, y = windows(1)
    with MicroBatcher(bp, max_wait_ms=0.0) as mb:
        with pytest.raises(ValueError, match="one sequence"):
            mb.submit(u, y)
        with pytest.raises(ValueError, match="to match u"):
            mb.submit(u[0], y[0, :, :0])
        out = mb(u[0], y[0], timeout=120)
    assert out.pred_mean.shape == (1, T, 1)
    with pytest.raises(ValueError):
        MicroBatcher(bp, max_batch=0)


def test_fold_seed_is_deterministic_and_distinct():
    seeds = {fold_seed(0, i) for i in range(100)} | {fold_seed(1, i) for i in range(100)}
    assert len(seeds) == 200
    assert fold_seed(3, 4) == fold_seed(3, 4)


@pytest.mark.cuda
def test_cuda_kernel_path_matches_plain_path(served):
    """On the GPU, gp_impl='pallas' launches the kernel once per step
    (4 blocked recognition + 7 forward steps at T = 8, recog_len 2) and
    matches gp_impl='solve_free' in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    from cbfssm_tpu_torch.ops import fused_predict as fp

    _, params = served
    u, y = windows(2)
    outs = {}
    for impl in ("pallas", "solve_free"):
        model = CBFSSM(tiny_config(impl), device="cuda")
        before = fp.fused_predict.launches
        outs[impl] = CompiledPredictor(model, params.to("cuda"), 2, T, seed=4)(u, y)
        torch.cuda.synchronize()
        assert fp.fused_predict.launches - before == (11 if impl == "pallas" else 0)
    for name in ("pred_mean", "pred_var", "internal_mean", "internal_var"):
        torch.testing.assert_close(getattr(outs["pallas"], name),
                                   getattr(outs["solve_free"], name), rtol=1e-10, atol=1e-12)
