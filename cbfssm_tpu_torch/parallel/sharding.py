"""Data parallelism over a process group (port of
``cbfssm_tpu/parallel/sharding.py``).

In the JAX package a meshed step is the unmeshed program: the batch
axis is sharded over the mesh's ``data`` axis, the parameters are
replicated, and XLA inserts the gradient ``psum``. Here every rank is a
process (one per GPU) and does by hand what XLA does:

- it takes the contiguous block of each batch's rows at its coordinate
  on ``data`` (:meth:`DataParallel.rows`), and the same block of the
  batch's draws (:func:`noise_rows`), so its draws are those of the
  unsharded batch;
- it backpropagates its *share* of the loss (:func:`mesh_loss`). Every
  model's ELBO is ``particle_sum / divisor + global_term``, where the
  global term (the inducing-point KL) counts once per batch: a rank's
  share is ``-(particle_sum_r / (divisor * rep) + global_term /
  ranks)``, so that the shares of all ranks add up to the batch's loss.
  Summing per-rank losses, as plain DDP would, counts the KL once per
  rank;
- the gradient is one ``all_reduce(SUM)`` of the flattened gradient
  over the mesh (:meth:`DataParallel.reduce_grads`), so every rank
  steps Adam on the same numbers and the parameters stay equal.

The loss is then the unsharded one up to summation order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cbfssm_tpu_torch.parallel import distributed


def make_mesh(n_devices: int | None = None, axis_name: str = "data", device="cuda"):
    """1-D mesh named ``axis_name`` over the process group's ranks, on
    ``device``'s type. ``n_devices`` defaults to the world size; a
    larger one raises, and so does a smaller one (every rank of the
    group trains)."""
    world = distributed.world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        # a smaller mesh would be a quiet change of the shard counts
        raise ValueError(f"make_mesh({n_devices}) but only {world} device(s) available")
    if n_devices < world:
        raise ValueError(f"make_mesh({n_devices}) over a group of {world} ranks: a mesh spans "
                         "every rank of the process group")
    return distributed.process_mesh((n_devices,), (axis_name,), device)


def pad_batch(arrays, batch_size: int):
    """Pad leading axes to ``batch_size`` with zeros; returns
    (padded_arrays, weights) where weights masks real rows (the loss is
    a weighted sum, so pad rows add nothing)."""
    n = arrays[0].shape[0]
    pad = batch_size - n
    if pad < 0:
        raise ValueError("batch larger than batch_size")
    padded = []
    for a in arrays:
        if pad:
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            a = np.pad(np.asarray(a), widths)
        padded.append(a)
    weights = np.concatenate([np.ones(n), np.zeros(pad)]).astype(padded[0].dtype)
    return padded, weights


def check_mesh(mesh, who: str) -> None:
    """Raise unless ``mesh`` is None or a ``DeviceMesh`` (a JAX mesh, say,
    is not one)."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise ValueError(f"{who}(mesh=) takes a torch DeviceMesh over the process group "
                         "(parallel.make_mesh or distributed.process_mesh; ROADMAP A6.1), got "
                         f"{type(mesh).__name__}")


def mesh_group(mesh):
    """The process group of the whole mesh: its own group when 1-D,
    else the world group (a mesh spans the world)."""
    if mesh.ndim == 1:
        return mesh.get_group()
    return dist.group.WORLD


def noise_rows(noise, rows: slice):
    """Rows ``rows`` of one batch's draws: a noise dataclass
    (``RolloutNoise``, ``VoliroNoise``) cuts each field on its batch
    axis (the class's ``BATCH_AXES``, in field order); a tensor ``[T-1,
    B, S, 1]`` is cut on axis 1."""
    if dataclasses.is_dataclass(noise):
        fields = [getattr(noise, f.name) for f in dataclasses.fields(noise)]
        return type(noise)(*(t[(slice(None),) * axis + (rows,)]
                             for t, axis in zip(fields, type(noise).BATCH_AXES, strict=True)))
    return noise[:, rows]


class _Share(torch.autograd.Function):
    """``value`` forward, the gradient of ``share`` backward: the mesh's
    loss, differentiated as this rank's part of it."""

    @staticmethod
    def forward(ctx, share, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def mesh_loss(aux: dict, divisor, parts: int, group, ranks: int, replicated=frozenset()):
    """``(loss, aux)`` of the mesh from one rank's loss terms ``aux``.

    ``parts`` ranks hold disjoint parts of the batch's particle sum (the
    data shards, times the particle shards); each part is held by
    ``rep = ranks / parts`` ranks. The entries of ``aux`` not in
    ``replicated`` (the particle sum and the per-particle terms) are
    summed over ``group`` in one ``all_reduce`` and divided by ``rep``;
    ``particle_divisor`` becomes ``divisor``. The loss's value is
    ``-(particle_sum / divisor + global_term)`` of the summed terms, the
    same on every rank; its gradient is this rank's share
    ``-(particle_sum_r / (divisor * rep) + global_term / ranks)``, so
    :meth:`DataParallel.reduce_grads` (a sum over the mesh) gives the
    gradient of the loss."""
    rep = ranks // parts
    divisor = torch.as_tensor(divisor, dtype=aux["particle_sum"].dtype,
                              device=aux["particle_sum"].device)
    keys = [k for k in aux if k not in replicated and k != "particle_divisor"]
    packed = torch.stack([aux[k].detach() for k in keys])
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    if rep != 1:
        packed = packed / rep
    out = {k: v.detach() for k, v in aux.items()}
    out.update(zip(keys, packed.unbind()))
    out["particle_divisor"] = divisor
    value = -(out["particle_sum"] / divisor + out["global_term"])
    share = -(aux["particle_sum"] / (divisor * rep) + aux["global_term"] / ranks)
    return _Share.apply(share, value), out


class DataParallel:
    """The data axis of a mesh: batches are cut into row blocks over
    ``axis_name``, parameters and optimizer state are replicated, and
    gradients are summed over the whole mesh. ``DataParallel(None)`` is
    the unmeshed case (``n`` 1, nothing reduced)."""

    def __init__(self, mesh, axis_name: str = "data"):
        self.mesh = mesh
        self.axis_name = axis_name

    @property
    def n(self) -> int:
        """Size of the data axis (1 when the mesh lacks one, e.g. a
        particle-only mesh whose batches stay replicated)."""
        return distributed.axis_size(self.mesh, self.axis_name)

    @property
    def index(self) -> int:
        """This rank's coordinate on the data axis."""
        return distributed.axis_index(self.mesh, self.axis_name)

    @property
    def ranks(self) -> int:
        """Ranks in the mesh (1 without one)."""
        return 1 if self.mesh is None else int(self.mesh.size())

    @property
    def writer(self) -> bool:
        """Whether this rank writes the run's files (rank 0 of a mesh,
        always without one)."""
        return self.mesh is None or dist.get_rank() == 0

    @property
    def group(self):
        return None if self.mesh is None else mesh_group(self.mesh)

    def round_up_batch(self, batch_size: int) -> int:
        """Batch size padded up to a multiple of the data axis, so every
        rank gets equal shards."""
        n = self.n
        return ((batch_size + n - 1) // n) * n

    def rows(self, batch: int) -> slice:
        """This rank's rows of a batch of ``batch`` rows."""
        per = batch // self.n
        return slice(self.index * per, (self.index + 1) * per)

    def shard_rows(self, tensor, dim: int = 0):
        """This rank's contiguous block of a batch along ``dim``."""
        rows = self.rows(tensor.shape[dim])
        return tensor.narrow(dim, rows.start, rows.stop - rows.start)

    def loss(self, aux: dict, replicated=frozenset()):
        """:func:`mesh_loss` of this rank's rows: ``n`` parts over the
        mesh, divided by the aux's own ``particle_divisor``."""
        return mesh_loss(aux, aux["particle_divisor"].detach(), self.n, self.group, self.ranks,
                         replicated)

    def reduce_grads(self, grads: list) -> None:
        """Sum ``grads`` over the mesh in place: one ``all_reduce(SUM)``
        of their concatenation."""
        if self.mesh is None or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def all_reduce_scalars(self, values, op=dist.ReduceOp.SUM):
        """``values`` (a tensor of scalars) reduced with ``op`` over the
        mesh; the input is left as it was."""
        out = values.clone()
        if self.mesh is not None:
            dist.all_reduce(out, op=op, group=self.group)
        return out

    def barrier(self) -> None:
        """Wait for every rank of the mesh (after rank 0's file writes)."""
        if self.mesh is not None:
            dist.barrier(group=self.group)
