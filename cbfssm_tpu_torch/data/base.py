"""Dataset base class: normalization + sliding-window batching (port of
``cbfssm_tpu/data/base.py``; numpy only).

``rnn_batches`` keeps the reference's tail-window rule: if
``(num_points - length) % stride != 0`` the final ``length`` points are
appended as an extra window, so the sequence tail is always covered.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# The ``.mat`` files ship inside the JAX package's directory; reading
# them is reading data, and imports nothing of that package.
DEFAULT_DATA_DIR = Path(__file__).resolve().parents[2] / "cbfssm_tpu" / "data" / "data"


class BaseDS:
    """Holds raw [experiments, time, dim] arrays, z-score normalization
    stats, and windowed [windows, seq_len, dim] batch arrays."""

    dim_u: int | None = None
    dim_y: int | None = None

    def __init__(self, seq_len: int, seq_stride: int):
        self.seq_len = seq_len
        self.seq_stride = seq_stride
        self.train_in = np.empty(0)
        self.train_out = np.empty(0)
        self.test_in = np.empty(0)
        self.test_out = np.empty(0)
        self.train_in_batch = np.empty(0)
        self.train_out_batch = np.empty(0)
        self.test_in_batch = np.empty(0)
        self.test_out_batch = np.empty(0)
        self.mean = {"in": np.empty(()), "out": np.empty(())}
        self.std = {"in": np.empty(()), "out": np.empty(())}
        self.data_path = DEFAULT_DATA_DIR

    # --- normalization -------------------------------------------------

    def normalize_init(self, data_in: np.ndarray, data_out: np.ndarray) -> None:
        """Compute z-score stats from 2-D [samples, dim] arrays."""
        if data_in.ndim != 2 or data_out.ndim != 2:
            raise ValueError("normalize_init takes 2-D [samples, dim] arrays")
        self.mean["in"] = np.mean(data_in, axis=0)
        self.std["in"] = np.std(data_in - self.mean["in"], axis=0)
        self.mean["out"] = np.mean(data_out, axis=0)
        self.std["out"] = np.std(data_out - self.mean["out"], axis=0)

    def normalize(self, data, key: str):
        return (data - self.mean[key]) / self.std[key]

    def denormalize(self, data, key: str, shift: bool = True):
        res = data * self.std[key]
        return res + self.mean[key] if shift else res

    # --- windowing -----------------------------------------------------

    @staticmethod
    def rnn_batches(x: np.ndarray, length: int, stride: int) -> np.ndarray:
        """Slide a window of ``length`` every ``stride`` steps over each
        experiment of ``x`` [experiments, time, dim]; append the tail
        window when the remainder is nonzero; concatenate experiments."""
        if x.ndim != 3:
            raise ValueError("data must be shaped as [experiments x time x dimension]")
        num_points = x.shape[1]
        if num_points < length:
            raise ValueError("Sequence length must be shorter than data.")
        starts = np.arange(0, num_points - length + 1, stride)
        if (num_points - length) % stride > 0:
            starts = np.append(starts, num_points - length)
        # [experiments, windows, length, dim] via one fancy-index gather
        idx = starts[:, None] + np.arange(length)[None, :]
        return x[:, idx, :].reshape(-1, length, x.shape[2])

    def get_batches(self, seq_len: int, seq_stride: int):
        return (
            self.rnn_batches(self.train_in, seq_len, seq_stride),
            self.rnn_batches(self.train_out, seq_len, seq_stride),
            self.rnn_batches(self.test_in, seq_len, seq_stride),
            self.rnn_batches(self.test_out, seq_len, seq_stride),
        )

    def create_batches(self) -> None:
        (
            self.train_in_batch,
            self.train_out_batch,
            self.test_in_batch,
            self.test_out_batch,
        ) = self.get_batches(self.seq_len, self.seq_stride)
        self.print_stats()

    def print_stats(self) -> None:
        print("Dataset Stats:")
        print("  sequence length: %d" % self.seq_len)
        print("  train samples: %d" % (self.train_in.shape[0] * self.train_in.shape[1]))
        print("  train sequences: %d" % self.train_in_batch.shape[0])
        print("  test samples: %d" % (self.test_in.shape[0] * self.test_in.shape[1]))
        print("  test sequences: %d" % self.test_in_batch.shape[0])
