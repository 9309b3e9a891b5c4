"""Particle (sample-axis) parallelism (port of
``cbfssm_tpu/parallel/particle.py``).

Particles are conditionally iid given a sequence, and every model's ELBO
decomposes as

    elbo = sum_over_particles(per-sequence terms) / divisor + global

(the models give ``particle_sum`` / ``particle_divisor`` /
``global_term`` in their aux dict; for PR-SSM the divisor is faithfully
1). That makes the particle axis a second data-parallel axis: each rank
of the mesh's ``particle`` axis runs the same model with ``samples / n``
particles and draws from its own seed, the particle sums are summed over
the mesh, and the parameter-only global term is computed on every rank
and counted once (:func:`~cbfssm_tpu_torch.parallel.sharding.mesh_loss`).

Use it where the window batch alone cannot fill the devices (the Sarcos
config: batch 5, 20 particles; a ('data', 'particle') mesh of 5 x 4
keeps 20 GPUs busy).
"""

from __future__ import annotations

import dataclasses

import torch

from cbfssm_tpu_torch.config import as_config
from cbfssm_tpu_torch.parallel import distributed
from cbfssm_tpu_torch.parallel.sharding import mesh_group, mesh_loss
from cbfssm_tpu_torch.streams import fold_seed


class ParticleParallel:
    """Wraps a model class so ``loss`` shards the particle axis over
    ``axis_name`` of ``mesh`` (and the batch axis over ``data_axis``,
    where given). ``local_model`` runs this rank's ``samples / n``
    particles; ``model`` is the full-config model, which ``init``,
    ``predict`` and ``var_dict`` use."""

    # Fallback for model classes that do not declare REPLICATED_AUX: aux
    # entries that are functions of the (replicated) parameters only,
    # equal on every rank, so never summed.
    _REPLICATED_AUX = frozenset(
        {"kl_z", "kl_z_f", "kl_z_b", "n_reg", "l_reg", "global_term", "particle_divisor"}
    )

    def __init__(self, model_cls, config, mesh, axis_name: str = "particle",
                 data_axis: str | None = None, device="cuda"):
        cfg = as_config(config)
        self.n = distributed.axis_size(mesh, axis_name)
        if cfg.samples % self.n != 0:
            raise ValueError(f"samples ({cfg.samples}) must divide by the particle axis size "
                             f"({self.n})")
        self.total_samples = cfg.samples
        self.local_model = model_cls(dataclasses.replace(cfg, samples=cfg.samples // self.n),
                                     device=device)
        self.model = model_cls(cfg, device=device)
        self.mesh = mesh
        self.axis_name = axis_name
        self.data_axis = data_axis
        self.n_data = distributed.axis_size(mesh, data_axis) if data_axis else 1
        self.device = self.model.device
        self.dtype = self.model.dtype
        self.np_dtype = self.model.np_dtype
        self.config = self.model.config
        # whether the model normalizes by the particle count is a property
        # of its class (PR-SSM does not), never of the local divisor,
        # which is 1 whenever S / n is
        normalized = getattr(model_cls, "PARTICLE_NORMALIZED", True)
        self.divisor = float(self.total_samples) if normalized else 1.0
        self.replicated = frozenset(getattr(model_cls, "REPLICATED_AUX", self._REPLICATED_AUX))

    def init(self, generator):
        return self.model.init(generator)

    def var_dict(self, params):
        return self.model.var_dict(params)

    def predict(self, params, u, y, generator=None, condition: bool = False, noise=None):
        return self.model.predict(params, u, y, generator, condition, noise)

    @property
    def shard_index(self) -> int:
        """This rank's index on the (particle, data) grid: ``p + n * d``,
        unique over the grid (folding in only the particle index would
        give every data shard at one particle position the same draws)."""
        p = distributed.axis_index(self.mesh, self.axis_name)
        d = distributed.axis_index(self.mesh, self.data_axis) if self.data_axis else 0
        return p + self.n * d

    def shard_seed(self, seed: int) -> int:
        """This rank's seed of a batch seeded ``seed``."""
        return fold_seed(seed, self.shard_index)

    def loss(self, params, u, y, generator=None, condition: bool = True, weights=None,
             noise=None):
        """Sharded negative ELBO with the full aux: ``(loss, aux)`` equal
        on every rank, the per-particle aux terms summed over the mesh.
        ``u``, ``y``, ``weights`` are the whole batch (with ``data_axis``
        this rank takes its row block). This rank draws its particles
        from a generator seeded :meth:`shard_seed` of ``generator``'s seed
        (a ``torch.Generator`` or an int), or takes them ready-made as
        ``noise`` (its shard's draws). The loss's gradient is this rank's
        share: sum it over the mesh (``DataParallel.reduce_grads``)."""
        kw = dict(dtype=self.dtype, device=self.device)
        u, y = torch.as_tensor(u, **kw), torch.as_tensor(y, **kw)
        weights = (torch.ones(u.shape[0], **kw) if weights is None
                   else torch.as_tensor(weights, **kw))
        if self.data_axis:
            rows = distributed.process_rows(self.mesh, u.shape[0], self.data_axis)
            start, stop = int(rows[0]), int(rows[-1]) + 1
            u, y, weights = u[start:stop], y[start:stop], weights[start:stop]
        gen = None
        if noise is None:
            if generator is None:
                raise ValueError("need a generator (or its seed) or ready-made noise")
            seed = generator if isinstance(generator, int) else generator.initial_seed()
            gen = torch.Generator(device=self.device).manual_seed(self.shard_seed(seed))
        _, aux = self.local_model.loss(params, u, y, gen, condition, weights, noise)
        return mesh_loss(aux, self.divisor, self.n * self.n_data, mesh_group(self.mesh),
                         int(self.mesh.size()), self.replicated)
