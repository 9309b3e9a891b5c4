"""Probabilistic evaluation: predictive NLL + calibration coverage
(the port's own copy of ``cbfssm_tpu/outputs/calibration.py``: numpy and
``scipy.special.ndtri``, nothing of JAX).

The reference's evaluation surface stops at point accuracy (mse.txt,
cbfssm/outputs/outputs.py:118-131) even though every artifact plots a
1.96-sigma band — nothing ever CHECKS the band. These metrics do, for
the same moment-matched Gaussian predictive the plots show
(``PredictOutput.pred_mean/pred_var``, models/base.py:154-171),
evaluated in denormalized units like the reference's MSE:

* **Gaussian predictive NLL** per point:
  ``0.5*log(2*pi*var) + (y-mean)^2 / (2*var)`` — lower is better; the
  standard probabilistic-forecast score the PR-SSM/CBF-SSM line of
  papers report alongside RMSE.
* **Central-interval coverage** at nominal levels p: the fraction of
  test points with ``|y-mean| <= z_p * std`` where
  ``z_p = Phi^-1((1+p)/2)``. A calibrated model's empirical coverage
  matches p; the 0.95 row is exactly "how often the plotted 1.96-sigma
  band contains the truth".
* **ECE** — mean |empirical - nominal| over the levels.
* **Standardized-error RMS** — RMS of ``(y-mean)/std``; 1.0 when the
  predictive variance matches the error scale (<1 over-dispersed,
  >1 over-confident).

All functions take denormalized numpy arrays and run host-side: the
arrays are tiny next to the prediction programs that produce them.
"""

from __future__ import annotations

import numpy as np
from scipy.special import ndtri

# nominal central-interval levels reported by default; 0.95 matches the
# 1.96-sigma band drawn in predict_{train,test}.pdf
LEVELS = (0.5, 0.8, 0.9, 0.95, 0.99)


def z_score(level: float) -> float:
    """Two-sided standard-normal quantile for a central interval."""
    if not 0.0 < level < 1.0:
        raise ValueError(f"level must be in (0, 1), got {level}")
    return float(ndtri((1.0 + level) / 2.0))


def gaussian_nll(mean, var, y) -> np.ndarray:
    """Per-point Gaussian negative log-likelihood (any shape)."""
    mean, var, y = (np.asarray(a, dtype=np.float64) for a in (mean, var, y))
    return 0.5 * (np.log(2.0 * np.pi * var) + np.square(y - mean) / var)


def summarize(mean, var, y, levels=LEVELS) -> dict:
    """All metrics for one set of predictions.

    Args:
      mean / var / y: broadcast-compatible arrays of predictive mean,
        predictive variance, and ground truth (denormalized).
      levels: nominal central-interval levels for coverage.

    Returns a dict: ``nll`` (mean per point), ``coverage`` ({level:
    empirical}), ``ece``, ``sde_rms``, ``n_points``.
    """
    mean, var, y = (np.asarray(a, dtype=np.float64) for a in (mean, var, y))
    std = np.sqrt(var)
    err = np.abs(y - mean)
    coverage = {
        float(p): float(np.mean(err <= z_score(p) * std)) for p in levels
    }
    ece = float(np.mean([abs(emp - p) for p, emp in coverage.items()]))
    return {
        "nll": float(np.mean(gaussian_nll(mean, var, y))),
        "coverage": coverage,
        "ece": ece,
        "sde_rms": float(np.sqrt(np.mean(np.square(err / std)))),
        "n_points": int(err.size),
    }


def accumulate(parts: list) -> dict:
    """Combine per-experiment :func:`summarize` dicts, weighting every
    POINT equally (experiments may have different lengths)."""
    if not parts:
        raise ValueError("no experiments to accumulate")
    n = np.array([p["n_points"] for p in parts], dtype=np.float64)
    w = n / n.sum()
    levels = list(parts[0]["coverage"])
    coverage = {
        p: float(sum(w_i * part["coverage"][p] for w_i, part in zip(w, parts)))
        for p in levels
    }
    return {
        "nll": float(sum(w_i * p["nll"] for w_i, p in zip(w, parts))),
        "coverage": coverage,
        "ece": float(np.mean([abs(emp - p) for p, emp in coverage.items()])),
        "sde_rms": float(
            np.sqrt(sum(w_i * p["sde_rms"] ** 2 for w_i, p in zip(w, parts)))
        ),
        "n_points": int(n.sum()),
    }


def format_report(stats: dict) -> str:
    """calibration.txt body (mse.txt's plain-text style)."""
    lines = [
        "NLL/point:  %f" % stats["nll"],
        "SDE RMS:    %f" % stats["sde_rms"],
        "ECE:        %f" % stats["ece"],
        "coverage (nominal -> empirical):",
    ]
    for p, emp in sorted(stats["coverage"].items()):
        lines.append("  %.2f -> %f" % (p, emp))
    lines.append("points:     %d" % stats["n_points"])
    return "\n".join(lines) + "\n"
