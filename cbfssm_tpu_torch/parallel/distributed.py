"""Process-group wiring (port of ``cbfssm_tpu/parallel/distributed.py``).

The JAX package is one program over the devices of every host: its
``initialize()`` brings up JAX's coordination service and
``process_mesh()`` lays one mesh over all chips. PyTorch runs one
process per GPU instead: ``torchrun --nproc-per-node N script.py``
starts the processes and sets their environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``);
:func:`initialize` joins this process to the group
(``torch.distributed.init_process_group``), :func:`process_mesh` lays a
``DeviceMesh`` over every rank, and :func:`process_rows` /
:func:`host_local_batch` give this rank its rows of a batch.

A mesh here always spans the whole process group, and each rank owns
one device: the contiguous row block at its coordinate on the data
axis.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

_initialized = False
_noop_latched = False  # a single-process call already no-op'd


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    backend: str | None = None,
) -> None:
    """Idempotent ``torch.distributed.init_process_group``.

    Under ``torchrun`` pass nothing: the rank, the world size, the
    coordinator (``MASTER_ADDR:MASTER_PORT``) and the local device
    (``LOCAL_RANK``) come from its environment. Elsewhere pass the first
    three: ``coordinator_address`` is ``host:port`` (a TCP store on rank
    0) or any ``init_method`` URL such as ``file:///path/store``.
    ``local_device_ids`` selects this process's GPU (an int or a
    one-element sequence). ``backend`` is ``'nccl'`` when CUDA is
    available and ``'gloo'`` otherwise; nothing falls back from one to
    the other.

    ``num_processes=1`` without an address is a no-op that latches:
    a later argument-less call is then suppressed with a warning (pass
    arguments explicitly to join a real group after such a call). A
    call after a successful one, or in a process whose group is already
    up, does nothing.
    """
    global _initialized, _noop_latched
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    if num_processes == 1 and coordinator_address is None:
        # nothing to coordinate; not latching _initialized keeps a later
        # explicit multi-process bring-up possible
        _noop_latched = True
        return
    explicit = any(
        a is not None
        for a in (coordinator_address, num_processes, process_id, local_device_ids, backend)
    )
    if _noop_latched and not explicit:
        warnings.warn(
            "distributed.initialize(): argument-less call suppressed because an earlier "
            "initialize(num_processes=1) already no-op'd in this process; to join a "
            "torchrun group, pass arguments explicitly or drop the single-process call",
            RuntimeWarning,
            stacklevel=2,
        )
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if local_device_ids is None:
        local_device_ids = int(env.get("LOCAL_RANK", 0))
    if not isinstance(local_device_ids, int):
        (local_device_ids,) = local_device_ids
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device_ids)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    _initialized = True


def shutdown() -> None:
    """Leave the process group (``destroy_process_group``); a later
    :func:`initialize` may join another."""
    global _initialized, _noop_latched
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = _noop_latched = False


def world_size() -> int:
    """Ranks in the process group; raises when there is none."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call cbfssm_tpu_torch.parallel.distributed.initialize() first "
            "(under torchrun it reads the launcher's environment)")
    return dist.get_world_size()


def process_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...], device="cuda"):
    """A ``DeviceMesh`` of ``axis_sizes`` named ``axis_names`` over every
    rank of the process group (``init_device_mesh``), on ``device``'s
    type. The sizes must multiply to the world size."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError("axis_sizes and axis_names must have equal length")
    total = int(np.prod(axis_sizes))
    world = world_size()
    if total != world:
        raise ValueError(f"mesh of {tuple(axis_sizes)} needs {total} devices, have {world} "
                         "(global)")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis_name: str) -> int:
    """The size of ``mesh``'s axis ``axis_name``; 1 when the mesh has no
    such axis (its batches are then replicated)."""
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis_name)))


def axis_index(mesh, axis_name: str) -> int:
    """This rank's coordinate on ``mesh``'s axis ``axis_name`` (0 when
    the mesh has no such axis)."""
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis_name))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def process_rows(mesh, global_batch: int, axis_name: str = "data") -> np.ndarray:
    """The global row indices of a ``[global_batch, ...]`` batch this
    rank loads: the contiguous block at its coordinate on
    ``axis_name`` (every row when the mesh lacks the axis)."""
    n = axis_size(mesh, axis_name)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide by the {n} ranks of "
                         f"axis '{axis_name}'")
    per = global_batch // n
    start = axis_index(mesh, axis_name) * per
    return np.arange(start, start + per, dtype=np.int64)


def host_local_batch(mesh, array, axis_name: str = "data", global_batch: int | None = None):
    """This rank's shard of a batch as a tensor on its device: ``array``
    holds the rows ``process_rows(mesh, global_batch, axis_name)`` in
    that order (``global_batch`` defaults to its rows times the axis
    size)."""
    array = np.asarray(array)
    if global_batch is None:
        global_batch = array.shape[0] * axis_size(mesh, axis_name)
    rows = process_rows(mesh, global_batch, axis_name)
    if rows.size != array.shape[0]:
        raise ValueError(
            f"local array has {array.shape[0]} rows but this process owns {rows.size} of the "
            f"global batch {global_batch} — load exactly process_rows(mesh, global_batch)")
    return torch.as_tensor(array, device=mesh_device(mesh))
