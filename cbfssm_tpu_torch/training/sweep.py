"""Hyperparameter sweeps as one lane-batched program (port of
``cbfssm_tpu/training/sweep.py``).

The reference found its per-dataset loss shaping by manual search (e.g.
the per-task (lambda_1, k_factor) pairs of ``run_smallscale``). The
models read those loss-time fields inside ``loss`` and accept them as
tensors (``models.base.hyper``), so a grid of N settings trains as N
lanes of :class:`~cbfssm_tpu_torch.training.multiseed.MultiSeedTrainer`:
the hypers are stacked on the lane axis beside the params, and each lane
runs the model with its own values.

:class:`SweptModel` keeps the swept values in its params (``hyper``,
after the model's leaves) and runs the underlying model with them
substituted into its config. They are never optimizer leaves: the
trainer trains only the model's leaves, so the values cannot drift.
``learning_rate`` is swept through the per-lane Adam instead.

Only loss-time fields are sweepable. Fields read at ``init`` (zeta_*,
gp_var, var_x, ...) or structural fields (shapes, dtypes, recog_len)
select different programs, not different values; sweep those the
pedestrian way. After training, the winning point's values are folded
into the directory's ``model_meta.json``
(:func:`~cbfssm_tpu_torch.model_store.fold_config_updates`), so the
rebuilt model is the one whose params ``best.ckpt`` holds.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import numpy as np
import torch

from cbfssm_tpu_torch import model_store
from cbfssm_tpu_torch.config import as_config
from cbfssm_tpu_torch.training.multiseed import MultiSeedTrainer

# Loss-time fields a model may read (each model narrows them with its
# SWEEPABLE_HYPERS); learning_rate goes through the optimizer.
SWEEPABLE = {"k_factor", "loss_factors", "loglik_factor", "n_beta", "l_beta", "learning_rate"}


@dataclasses.dataclass
class SweptParams:
    """A swept model's params: the model's own, then the swept values."""

    model: object  # the underlying model's params
    hyper: dict  # field -> tensor (0-d, or [k] for a vector field)

    def tensors(self) -> list:
        """The model's leaves, then the swept values in field order."""
        return [*self.model.tensors(), *self.hyper.values()]

    def with_tensors(self, tensors) -> "SweptParams":
        t = list(tensors)
        n = len(t) - len(self.hyper)
        return SweptParams(self.model.with_tensors(t[:n]), dict(zip(self.hyper, t[n:])))

    def to(self, *args, **kwargs) -> "SweptParams":
        return self.with_tensors([t.to(*args, **kwargs) for t in self.tensors()])

    def detach(self) -> "SweptParams":
        return self.with_tensors([t.detach() for t in self.tensors()])


class SweptModel:
    """A model whose loss-time config fields ``fields`` come from its
    params (:class:`SweptParams`), so that settings stack on lanes like
    seeds. ``loss`` / ``predict`` run the underlying model with the
    params' values substituted into its config; everything else is a
    template instance of ``model_cls`` built from ``config``."""

    def __init__(self, model_cls, config, fields, device="cuda"):
        self.model_cls = model_cls
        self.base_config = as_config(config)
        self.fields = tuple(fields)
        self.template = model_cls(self.base_config, device=device)
        self.config = self.template.config
        self.device = self.template.device
        self.dtype = self.template.dtype
        self.np_dtype = self.template.np_dtype
        self.samples = self.template.samples
        # the trailing params leaves that the trainer does not train
        self.frozen_leaves = len(self.fields)

    def _rebuild(self, hyper: dict):
        """The template with ``hyper`` in its config (no re-construction:
        the swept fields are read only at loss time)."""
        model = copy.copy(self.template)
        model.config = dataclasses.replace(
            self.base_config, **{k: v.detach() for k, v in hyper.items()})
        return model

    def init(self, generator: torch.Generator) -> SweptParams:
        hyper = {f: torch.as_tensor(np.asarray(getattr(self.base_config, f), dtype=np.float64),
                                    dtype=self.dtype, device=self.device)
                 for f in self.fields}
        return SweptParams(self.template.init(generator), hyper)

    def draw_noise(self, generator: torch.Generator, t_len: int, b: int, out=None):
        return self.template.draw_noise(generator, t_len, b, out)

    def loss(self, params: SweptParams, u, y, generator=None, condition: bool = True,
             weights=None, noise=None):
        return self._rebuild(params.hyper).loss(params.model, u, y, generator, condition,
                                                weights, noise)

    def predict(self, params: SweptParams, u, y, generator=None, condition: bool = False,
                noise=None):
        return self._rebuild(params.hyper).predict(params.model, u, y, generator, condition,
                                                   noise)

    def var_dict(self, params: SweptParams) -> dict:
        out = dict(self.template.var_dict(params.model))
        out.update({f"sweep {k}": v for k, v in params.hyper.items()})
        return out


class SweepTrainer(MultiSeedTrainer):
    """Trains every point of a hyperparameter grid as one lane-batched
    program.

    ``sweep`` maps a field name to an [n] array (or [n, k] for a vector
    field like ``loss_factors``); all share the leading length n. The
    fields are checked against the model's ``SWEEPABLE_HYPERS`` (the
    loss-time fields it reads), so a field the model ignores fails
    before a grid whose best value would be noise is trained.

    By default (``vary_init=False``) every grid point shares one init,
    one shuffle order and one noise stream, so loss differences come
    from the grid alone (a constant grid gives identical lanes);
    ``vary_init=True`` gives each point its own, as MultiSeedTrainer
    does (to replicate points over seeds, see :meth:`product_grid`).

    After ``train``, :meth:`best_seed` is the best point by train loss
    and :meth:`best_config` its values, also written to
    ``sweep_best.json``. Train losses rank points only when the grid
    does not change the loss's own scale; when sweeping ``loss_factors``
    or ``loglik_factor``, rank by an evaluation metric instead
    (:meth:`evaluate_rmse` or :meth:`evaluate_calibration`).

    ``mesh`` splits the grid's points over the mesh's ``seed_axis`` as
    ``MultiSeedTrainer`` splits its lanes; the grid's size must divide
    by the axis. ``epochs_per_dispatch`` is ``MultiSeedTrainer``'s.
    """

    def __init__(self, model_cls, config, sweep: dict, model_dir, seed: int = 0,
                 vary_init: bool = False, mesh=None, seed_axis: str = "data",
                 metrics_path=None, device="cuda", epochs_per_dispatch=None):
        if not sweep:
            raise ValueError("sweep must name at least one field")
        allowed = frozenset(getattr(model_cls, "SWEEPABLE_HYPERS", SWEEPABLE)) | {"learning_rate"}
        unknown = set(sweep) - allowed
        if unknown:
            raise ValueError(
                f"not sweepable for {model_cls.__name__} (its loss reads "
                f"{sorted(allowed)}): {sorted(unknown)}")
        sweep = {k: np.asarray(v, dtype=np.float64) for k, v in sweep.items()}
        for k, v in sweep.items():
            if v.ndim < 1:
                raise ValueError(
                    f"sweep['{k}'] must be a length-n array of grid values, got a scalar ({v!r})")
        lengths = {v.shape[0] for v in sweep.values()}
        if len(lengths) != 1:
            raise ValueError(f"sweep arrays must share length, got {lengths}")
        self.sweep = sweep
        self._lr = sweep.pop("learning_rate", None)
        self._vary_init = vary_init
        model = SweptModel(model_cls, config, tuple(sweep), device=device)
        super().__init__(model, model_dir, n_seeds=lengths.pop(), seed=seed, mesh=mesh,
                         seed_axis=seed_axis, metrics_path=metrics_path,
                         epochs_per_dispatch=epochs_per_dispatch)

    def _stacked_init(self):
        if self._vary_init:
            params = super()._stacked_init()
        else:
            # one shared init: loss differences come from the grid alone
            one = self.model.init(torch.Generator(device=self.device).manual_seed(self.seed))
            params = one.with_tensors([t.expand((len(self.lanes),) + t.shape).clone()
                                       for t in one.tensors()])
        # the grid on the stacked hyper leaves (a retrain then loads the
        # checkpoint's, which init_state holds against this grid)
        hyper = {k: torch.as_tensor(v[self._lanes], dtype=self.model.dtype, device=self.device)
                 for k, v in self.sweep.items()}
        return SweptParams(params.model, hyper)

    def _learning_rates(self):
        return super()._learning_rates() if self._lr is None else self._lr

    def _epoch_indices(self, n, batch_size, shuffle: bool):
        if self._vary_init:
            return super()._epoch_indices(n, batch_size, shuffle)
        idx, w = self._single_indices(n, batch_size, shuffle)

        def tile(a):
            return np.repeat(a[None], len(self.lanes), axis=0)

        return tile(idx), tile(w)

    def _noises(self, epoch, split, i, b, t_len) -> list:
        """With the shared stream, every lane takes lane 0's draws."""
        if self._vary_init:
            return super()._noises(epoch, split, i, b, t_len)
        return [self._lane_noise(epoch, split, i, 0, b, t_len)] * len(self.lanes)

    def init_state(self, retrain: bool = False):
        super().init_state(retrain)
        if not retrain:
            return
        # the checkpoint's values override the grid: a changed grid would
        # train the old values while best_config() reports the new ones
        grids = {k: (self.params.hyper[k], torch.as_tensor(v[self._lanes],
                                                            dtype=self.model.dtype))
                 for k, v in self.sweep.items()}
        if self._lr is not None:
            grids["learning_rate"] = (self.opt.lr, torch.as_tensor(self._lr[self._lanes],
                                                                    dtype=torch.float64))
        for k, (stored, want) in grids.items():
            stored = stored.detach().cpu()
            if stored.shape != want.shape or not torch.equal(stored, want):
                raise ValueError(
                    f"retrain grid mismatch for '{k}': the checkpoint holds "
                    f"{stored.tolist()} but this trainer was constructed with "
                    f"{want.tolist()}; resume with the original grid or start a fresh model_dir")

    def train(self, ds, epochs: int, retrain: bool = False):
        super().train(ds, epochs, retrain)
        if self._writer:
            best = self.best_config()
            with open(os.path.join(self.model_dir, "sweep_best.json"), "w") as f:
                json.dump(best, f, indent=2)
            model_store.fold_config_updates(self.model_dir, best,
                                            note="sweep best point (by train loss)")
        self._barrier()

    @staticmethod
    def product_grid(sweep: dict, seeds_per_point: int) -> dict:
        """The grid with every point repeated ``seeds_per_point`` times
        (use with ``vary_init=True`` for independent inits): point p's
        replicates are lanes [p * seeds_per_point, (p + 1) *
        seeds_per_point). :meth:`grouped` folds per-lane results back."""
        return {k: np.repeat(np.asarray(v), seeds_per_point, axis=0) for k, v in sweep.items()}

    @staticmethod
    def grouped(per_lane, seeds_per_point: int) -> np.ndarray:
        """[n_points * seeds_per_point, ...] lane values -> [n_points,
        seeds_per_point, ...]."""
        a = np.asarray(per_lane)
        return a.reshape(-1, seeds_per_point, *a.shape[1:])

    def best_config(self) -> dict:
        """The values of the best grid point (by train loss)."""
        i = self.best_seed()
        out = {k: np.asarray(v)[i].tolist() for k, v in self.sweep.items()}
        if self._lr is not None:
            out["learning_rate"] = float(np.asarray(self._lr)[i])
        return out
