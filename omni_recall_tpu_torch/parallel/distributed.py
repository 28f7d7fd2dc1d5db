"""Multi-host initialization (PyTorch port of
omni_recall_tpu/parallel/distributed.py).

Within one process the shard mesh (parallel/mesh.py) lists its devices;
across processes a ``torch.distributed`` process group joins the meshes,
and the sharded scorer's collectives (parallel/sharded.py) run over it:
NCCL between cards, gloo on the CPU. The group must exist before the
engine is built, so the app calls ``initialize_multihost`` first.

The reference's three variables carry over, so a deployment's settings need
no change: ``JAX_COORDINATOR_ADDRESS`` (host:port of rank 0),
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. As in the reference, each
process keeps the whole host mirrors and uploads only its own shards' rows.
"""

from __future__ import annotations

import os


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Initialize the default ``torch.distributed`` process group from the
    arguments or the reference's variables (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID). A no-op returning False when no
    coordinator is configured (one host). ``coordinator_address`` is
    ``host:port`` (read as ``tcp://host:port``) or an ``init_method`` URL
    (``tcp://``, ``file://``); ``backend`` defaults to NCCL where CUDA is
    available, else gloo."""
    import torch
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator_address:
        return False
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "1")
    )
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0")
    )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def default_group():
    """The default process group when one is initialized, else None (the
    group ``shards_mesh`` takes for a mesh across processes)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None
