"""Two-run backward-pass segmentation masks (numpy; port of
``cbfssm_tpu/models/segmentation.py``, array-equal to it).

The CBF-SSM backward (recognition) pass bounds error growth on unstable
systems by splitting time into segments of length ``recog_len`` (the
paper's t' trick): two reverse-time passes alternate — each pass
resamples its hidden state from N(0,1) at its own segment boundaries,
burns in for one segment, and contributes (writes) the next segment;
together they cover every timestep (reference cbfssm/model/cbfssm.py:
122-128).

The reference evaluates these conditions dynamically inside a
``tf.while_loop``. Here they are *static* functions of (t, recog_len)
and are precomputed as boolean mask arrays that become scan inputs —
no control flow inside the compiled step.

Conventions (t = absolute time index, L = recog_len):
  run 0: resample where (t + 1) % 2L == 0;      write where t % 2L < L
  run 1: resample where (t + L + 1) % 2L == 0;  write where t % 2L >= L
"""

from __future__ import annotations

import numpy as np


def backward_masks(seq_len: int, recog_len: int):
    """Returns (resample [T, 2] bool, write_run0 [T] bool), indexed by
    absolute time t. The two runs' write masks are complements."""
    t = np.arange(seq_len)
    two_l = 2 * recog_len
    resample = np.stack(
        (
            (t + 1) % two_l == 0,
            (t + recog_len + 1) % two_l == 0,
        ),
        axis=1,
    )
    write_run0 = (t % two_l) < recog_len
    return resample, write_run0


def blocked_layout(seq_len: int, recog_len: int):
    """Geometry of the block-parallel backward decomposition.

    In a per-run frame shifted by that run's offset (run 0: 0, run 1:
    recog_len), BOTH runs resample exactly at shifted times
    t'' = 2L-1 (mod 2L) and write at t'' mod 2L < L. Because every
    segment starts from a fresh N(0,1) resample (and the t = T-1 entry
    state is the zero init), consecutive 2L-blocks exchange NO
    information — so all blocks can be processed in parallel as a batch
    dimension, cutting the reverse recursion's sequential depth from T
    to 2L.

    Returns (t_ext, n_blocks, shifts) where t_ext = n_blocks * 2L covers
    the longer (shifted) run with top padding, and shifts = (0, L).
    """
    two_l = 2 * recog_len
    t_ext = -(-(seq_len + recog_len) // two_l) * two_l
    return t_ext, t_ext // two_l, (0, recog_len)


def forward_condition_mask(seq_len: int, recog_len: int):
    """Per-step mask for the forward pass: during free-running prediction
    the Kalman-style conditioning update stays active for the first
    ``recog_len - 1`` transitions (reference cbfssm.py:227). Indexed by
    transition index t = 0 .. T-2."""
    t = np.arange(seq_len - 1)
    return t < (recog_len - 1)
