"""The port's native host loader (``cbfssm_tpu_torch.native``) against
the JAX package's (``cbfssm_tpu.native``) and numpy, bitwise: each
function, its fallback, the bounds check before the C gather, where the
library is built, and the data layer's use of it."""

import numpy as np
import pytest

from cbfssm_tpu import native as jax_native
from cbfssm_tpu.data import voliro_loader as jax_voliro_loader
from cbfssm_tpu.data.base import BaseDS as JaxBaseDS
from cbfssm_tpu_torch import native
from cbfssm_tpu_torch.data import voliro_loader
from cbfssm_tpu_torch.data.base import BaseDS


def numpy_gather(x, starts, length):
    idx = np.asarray(starts)[:, None] + np.arange(length)[None, :]
    return x[:, idx, :].reshape(-1, length, x.shape[2])


def wrapped_angles(rng, t=300, k=4, spread=0.8):
    base = np.cumsum(rng.normal(0, spread, size=(t, k)), axis=0)
    vec = ((base + np.pi) % (2 * np.pi)) - np.pi
    jumps = (rng.random(size=(t, k)) < 0.05) * 2 * np.pi * rng.choice([-1, 1], size=(t, k))
    return vec + jumps


def test_library_builds_under_build_dir():
    assert native.available(), "g++ build of cbfssm_tpu_torch/native/hostloader.cpp failed"
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.parts[-3:-1] == ("build", "cbfssm_tpu_torch")
    assert native.host_tag() in path.name
    assert not list(native.SRC.parent.glob("*.so")), "built into the package directory"


@pytest.mark.parametrize("shape,starts,length", [
    ((3, 40, 5), [0, 7, 14, 28], 12),
    ((2, 33, 3), [0, 5, 10, 15, 20, 25], 8),
    ((1, 10, 1), [0], 10),
    ((4, 20, 2), [], 6),
])
def test_window_gather_equals_jax_and_numpy(rng, shape, starts, length):
    x = rng.normal(size=shape)
    s = np.asarray(starts, dtype=np.int64)
    got = native.window_gather(x, s, length)
    np.testing.assert_array_equal(got, jax_native.window_gather(x, s, length))
    np.testing.assert_array_equal(got, numpy_gather(x, s, length))
    assert got.dtype == np.float64


@pytest.mark.parametrize("starts,length", [([0, 30], 12), ([-1, 4], 6)])
def test_window_gather_bounds_check(rng, starts, length):
    """An out-of-range window raises before the C gather (which would
    copy past the input), with the JAX package's message."""
    x = rng.normal(size=(2, 40, 3))
    s = np.asarray(starts, dtype=np.int64)
    with pytest.raises(IndexError, match="out of bounds") as got:
        native.window_gather(x, s, length)
    with pytest.raises(IndexError) as want:
        jax_native.window_gather(x, s, length)
    assert str(got.value) == str(want.value)


def test_unwrap_angles_equals_jax_and_python(rng):
    vec = wrapped_angles(rng)
    threshold = 2.0 / 3.0 * np.pi
    got = native.unwrap_angles(vec, threshold)
    np.testing.assert_array_equal(got, jax_native.unwrap_angles(vec, threshold))
    assert not np.shares_memory(got, vec)
    np.testing.assert_array_equal(got, _python_unwrap(vec, threshold))


def _python_unwrap(vec, threshold):
    """The reference filter (voliro_loader.py:141-158) as a loop."""
    out = np.zeros_like(vec)
    out[0] = vec[0]
    for k in range(vec.shape[1]):
        for i in range(1, vec.shape[0]):
            v, prev = vec[i, k], out[i - 1, k]
            if v - prev > threshold:
                cand = v - 2 * np.pi
            elif v - prev < -threshold:
                cand = v + np.pi
                if cand - prev < -threshold:
                    cand = v + 2 * np.pi
            else:
                cand = v
            out[i, k] = cand
    return out


def test_normalize_cast_equals_jax_and_numpy(rng):
    x = rng.normal(3.0, 2.0, size=(50, 4))
    mean, std = x.mean(axis=0), x.std(axis=0)
    got = native.normalize_cast(x, mean, std)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, jax_native.normalize_cast(x, mean, std))
    np.testing.assert_array_equal(got, ((x - mean) / std).astype(np.float32))
    x3 = rng.normal(size=(2, 5, 3))
    np.testing.assert_array_equal(native.normalize_cast(x3, 1.0, 2.0),
                                  ((x3 - 1.0) / 2.0).astype(np.float32))


def test_fallbacks_give_identical_results(monkeypatch, rng):
    """Without the library every function still works, with the same
    numbers (unwrap_angles says so with None: the caller loops)."""
    x = rng.normal(size=(2, 20, 3))
    s = np.asarray([0, 4, 9], dtype=np.int64)
    vec = wrapped_angles(rng, t=80, k=2)
    mean, std = x.mean(axis=(0, 1)), x.std(axis=(0, 1))
    native_out = (native.window_gather(x, s, 6), native.normalize_cast(x, mean, std),
                  voliro_loader.unwrap_euler_angles(vec))
    monkeypatch.setattr(native, "load", lambda: None)
    assert not native.available()
    assert native.unwrap_angles(vec, 1.0) is None
    np.testing.assert_array_equal(native.window_gather(x, s, 6), native_out[0])
    np.testing.assert_array_equal(native.normalize_cast(x, mean, std), native_out[1])
    np.testing.assert_array_equal(voliro_loader.unwrap_euler_angles(vec), native_out[2])
    with pytest.raises(IndexError, match="out of bounds"):
        native.window_gather(x, np.asarray([15]), 6)


def test_data_layer_callers(monkeypatch, rng):
    """``unwrap_euler_angles`` filters through the library, as the JAX
    package's does; ``rnn_batches`` gathers with numpy alone at every
    dtype (the library's gather was no faster on the card's host: PERF.md).
    Both equal the JAX package's."""
    calls = []
    gather, unwrap = native.window_gather, native.unwrap_angles
    monkeypatch.setattr(native, "window_gather",
                        lambda *a: calls.append("gather") or gather(*a))
    monkeypatch.setattr(native, "unwrap_angles",
                        lambda *a: calls.append("unwrap") or unwrap(*a))
    x = rng.normal(size=(2, 33, 3))
    for dtype in (np.float64, np.float32):
        np.testing.assert_array_equal(BaseDS.rnn_batches(x.astype(dtype), 8, 5),
                                      JaxBaseDS.rnn_batches(x.astype(dtype), 8, 5))
    assert calls == []
    vec = wrapped_angles(rng, t=120, k=3)
    np.testing.assert_array_equal(voliro_loader.unwrap_euler_angles(vec),
                                  jax_voliro_loader.unwrap_euler_angles(vec))
    t = np.linspace(0, 2.5 * np.pi, 200)
    wrapped = ((t + np.pi) % (2 * np.pi)) - np.pi
    np.testing.assert_array_equal(voliro_loader.unwrap_euler_angles(wrapped),
                                  jax_voliro_loader.unwrap_euler_angles(wrapped))
    assert calls == ["unwrap", "unwrap"]
