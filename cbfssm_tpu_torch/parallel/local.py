"""A 1-D mesh of devices held by one process (the port of the single
controller ``jax.sharding.Mesh`` that ``FilterPool(mesh=)`` shards its
capacity axis over).

JAX's pool is one program placed on the devices of a mesh by one
process, with no collective. Torch's ``DeviceMesh`` (what
:func:`~cbfssm_tpu_torch.parallel.make_mesh` returns) spans a process
group, one rank per device; the pool has no process group. A
:class:`LocalMesh` is only a named list of devices: the caller places
row blocks on them and issues each block's work itself. Devices may
repeat (``local_mesh(["cuda:0", "cuda:0"])`` puts two blocks on one
card; torch has one CPU device, so ``local_mesh(["cpu"] * 4)`` is the
CPU's four-block mesh).

:func:`replica` and :func:`model_on` copy what every block reads (the
parameters, the precomputed operators, the model's own constants) to a
block's device.
"""

from __future__ import annotations

import copy
import dataclasses

import torch


def canonical_device(device) -> torch.device:
    """``device`` as one ``torch.device`` per device: ``"cuda"`` is the
    current card, and the CPU is one device whatever its index, so that
    two spellings of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        return torch.device("cpu")
    return device


class LocalMesh:
    """A 1-D mesh over ``devices`` of this process, named ``axis_name``:
    ``axis_names``, ``shape`` (a dict, as JAX's ``mesh.shape``) and
    ``devices`` (one per position on the axis)."""

    def __init__(self, devices, axis_name: str = "data"):
        devices = tuple(canonical_device(d) for d in devices)
        if not devices:
            raise ValueError("a local mesh needs at least one device")
        self.devices = devices
        self.axis_names = (axis_name,)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"LocalMesh({[str(d) for d in self.devices]}, axis_name={self.axis_names[0]!r})"


def local_mesh(devices, axis_name: str = "data") -> LocalMesh:
    """A :class:`LocalMesh` over ``devices`` (names or ``torch.device``s,
    repeats allowed), e.g. ``local_mesh(["cuda:0", "cuda:1"])``."""
    return LocalMesh(devices, axis_name)


def replica(tree, device):
    """``tree`` (a tensor, or a tuple, list, dict or dataclass of them,
    nested) with every tensor on ``device``: a bitwise copy, or the tree
    itself where it is there already."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*(replica(getattr(tree, f.name), device)
                            for f in dataclasses.fields(tree)))
    if isinstance(tree, dict):
        return {k: replica(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(replica(v, device) for v in tree)
    return tree


def model_on(model, device):
    """``model`` as it would be built on ``device``: the model itself when
    it lives there, else a shallow copy whose ``device`` is ``device`` and
    whose tensor attributes (constants such as Voliro's allocation
    matrix) are copied there."""
    device = canonical_device(device)
    if canonical_device(model.device) == device:
        return model
    moved = copy.copy(model)
    for name, value in vars(model).items():
        if isinstance(value, torch.Tensor):
            setattr(moved, name, value.to(device))
    moved.device = device
    return moved
