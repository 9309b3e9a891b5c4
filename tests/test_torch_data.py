"""The port's datasets against ``cbfssm_tpu.data`` on the ``.mat`` files
that ship in the repository: windows and normalization stats are
array-equal."""

import numpy as np
import pytest

from cbfssm_tpu import data as jdata
from cbfssm_tpu_torch import data


@pytest.mark.parametrize("name,seq_len,stride", [
    ("RoboMove", 300, 50),
    ("RoboMoveSimple", 300, 50),
    ("SpringNonlinear", 64, 30),
])
def test_dataset_matches_jax(name, seq_len, stride):
    got = getattr(data, name)(seq_len, stride)
    want = getattr(jdata, name)(seq_len, stride)
    assert (got.dim_u, got.dim_y) == (want.dim_u, want.dim_y)
    for attr in ("train_in", "train_out", "test_in", "test_out",
                 "train_in_batch", "train_out_batch", "test_in_batch", "test_out_batch"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr), err_msg=attr)
    for key in ("in", "out"):
        np.testing.assert_array_equal(got.mean[key], want.mean[key])
        np.testing.assert_array_equal(got.std[key], want.std[key])
    np.testing.assert_array_equal(got.denormalize(got.test_out, "out"),
                                  want.denormalize(want.test_out, "out"))


def test_explicit_data_dir(tmp_path):
    import shutil

    src = data.BaseDS(1, 1).data_path / "spring_nonlinear.mat"
    shutil.copy(src, tmp_path / "spring_nonlinear.mat")
    got = data.SpringNonlinear(50, 25, data_dir=tmp_path)
    want = data.SpringNonlinear(50, 25)
    np.testing.assert_array_equal(got.train_out_batch, want.train_out_batch)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("t_len,length,stride", [(20, 5, 5), (23, 5, 4), (10, 10, 3)])
def test_rnn_batches_tail_rule_matches_jax(rng, dtype, t_len, length, stride):
    x = rng.normal(size=(2, t_len, 3)).astype(dtype)
    got = data.BaseDS.rnn_batches(x, length, stride)
    np.testing.assert_array_equal(got, jdata.BaseDS.rnn_batches(x, length, stride))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got[-1], x[-1, -length:])  # the tail is covered


def test_rnn_batches_rejects_bad_input(rng):
    with pytest.raises(ValueError):
        data.BaseDS.rnn_batches(rng.normal(size=(10, 3)), 5, 1)
    with pytest.raises(ValueError):
        data.BaseDS.rnn_batches(rng.normal(size=(1, 4, 3)), 5, 1)
