"""Multi-GPU training (port of ``cbfssm_tpu/parallel``): one process per
GPU in a ``torch.distributed`` process group (``torchrun``), a
``DeviceMesh`` over the ranks, the batch rows sharded over its ``data``
axis (:class:`DataParallel`), the particles over a ``particle`` axis
(:class:`ParticleParallel`), and the collectives a call performs counted
by :mod:`~cbfssm_tpu_torch.parallel.census`. A :class:`LocalMesh`
(:func:`local_mesh`) is a 1-D mesh of devices of one process, which
``FilterPool(mesh=)`` shards its sessions over without a process group."""

from cbfssm_tpu_torch.parallel import census, distributed  # noqa: F401
from cbfssm_tpu_torch.parallel.local import LocalMesh, local_mesh  # noqa: F401
from cbfssm_tpu_torch.parallel.particle import ParticleParallel  # noqa: F401
from cbfssm_tpu_torch.parallel.sharding import (  # noqa: F401
    DataParallel,
    make_mesh,
    mesh_loss,
    noise_rows,
    pad_batch,
)
