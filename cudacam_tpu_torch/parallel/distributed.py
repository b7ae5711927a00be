"""Multi-process initialisation and the mesh over every process
(``cudacam_tpu/parallel/distributed.py`` on ``torch.distributed``).

One process per mesh place: NCCL between CUDA devices, gloo between CPU
processes (the tests). Nothing tells a process of its cluster, so the
coordinator's address, the world size and the rank are given here or in
the ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``)::

    from cudacam_tpu_torch.parallel.distributed import initialize, pod_mesh
    initialize("localhost:29500", num_processes=2, process_id=rank)
    mesh = pod_mesh(batch=1)          # every process on the row axis

The sharded pipeline then runs one tile per process: halo strips move with
``batch_isend_irecv`` and the round loop's pending flag with ``all_reduce``
(``parallel/mesh.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from cudacam_tpu_torch.parallel.mesh import DistTransport, TileMesh, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (idempotent). ``coordinator_address`` is
    ``host:port``; without it the ``env://`` variables are read. The
    backend is NCCL when a CUDA device is present, else gloo; with NCCL the
    process takes the device ``rank % device_count``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num_processes or -1,
                            rank=process_id if process_id is not None else -1)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def _transport() -> DistTransport:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised (call initialize() first)")
    nccl = dist.get_backend() == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return DistTransport(dist.get_rank(), dist.get_world_size(), device)


def pod_mesh(batch: int = 1, cols: int = 1) -> TileMesh:
    """The (b, y, x) mesh over every process of the group; the places left
    after ``batch`` and ``cols`` go to the row axis."""
    return make_mesh(batch=batch, cols=cols, transport=_transport())


def is_coordinator() -> bool:
    """True on rank 0, the process that owns logging and I/O."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0
