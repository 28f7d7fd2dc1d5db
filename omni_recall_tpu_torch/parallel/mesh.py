"""The 1-D shard mesh and the row split of the index planes (PyTorch port
of omni_recall_tpu/parallel/mesh.py).

The chunk index shards its row axis over a 1-D ``shards`` mesh: shard g of
S holds global rows [g * n_local, (g + 1) * n_local), n_local = rows / S.
A mesh is a list of local devices, one shard each; a device may appear more
than once, so one card (or the CPU) can hold several shards. With a
``torch.distributed`` process group the mesh spans processes as a JAX mesh
over ``jax.devices()`` spans hosts: each process holds ``len(devices)``
shards, and its local shard l is global shard ``rank * len(devices) + l``.
Host mirrors stay whole in every process; each process uploads only the
rows of its own shards.

``RowSharded`` is the port's counterpart of a row-sharded ``jax.Array``: the
global shape and dtype, and one tensor of n_local rows a local shard on the
shard's device. Where every local shard lies on one device the shards are
views of one tensor of the process's rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class ShardMesh:
    """A 1-D ``shards`` mesh: this process's shard devices and, for a mesh
    across processes, the process group (rank r holds global shards
    r * len(devices) ... (r + 1) * len(devices) - 1)."""

    devices: tuple[torch.device, ...]
    group: object | None = None  # a torch.distributed ProcessGroup
    rank: int = 0
    world: int = 1

    @property
    def local_shards(self) -> int:
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        """Global shard count (``mesh.devices.size`` of the JAX mesh)."""
        return self.world * len(self.devices)

    def shard_index(self, local: int) -> int:
        return self.rank * len(self.devices) + local

    @property
    def one_device(self) -> bool:
        """Every local shard on one device: shards are views of one tensor."""
        return len(set(self.devices)) == 1


def shards_mesh(n_devices: int | None = None, devices=None, group=None) -> ShardMesh:
    """1-D mesh over the chunk axis. Without ``devices``: the first
    ``n_devices`` of the ``torch.cuda.device_count()`` cards, as
    ``jax.devices()[:n]`` (one card gives a one-shard mesh). An explicit
    ``devices`` list may name a device more than once: ``["cpu"] * 8`` is
    eight CPU shards, ``["cuda:0"] * 4`` four shards on one card. ``group``
    (a ``torch.distributed`` process group) joins the processes' meshes
    into one of ``world_size * len(devices)`` shards."""
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")  # raises, naming the CPU option
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a shard mesh needs at least one device")
    if any(d.type == "cuda" and d.index is None for d in devs):
        devs = tuple(torch.device("cuda", torch.cuda.current_device())
                     if d.type == "cuda" and d.index is None else d for d in devs)
    if group is None:
        return ShardMesh(devs)
    import torch.distributed as dist

    return ShardMesh(devs, group, dist.get_rank(group), dist.get_world_size(group))


@dataclass
class RowSharded:
    """A row-major plane split over a mesh: ``shards[l]`` holds the n_local
    rows of local shard l on ``mesh.devices[l]``, from global row
    ``row0[l]``; ``shape`` is global."""

    shards: list[torch.Tensor]
    shape: torch.Size
    dtype: torch.dtype
    row0: list[int]

    @property
    def n_local(self) -> int:
        return self.shards[0].shape[0]

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def element_size(self) -> int:
        return self.shards[0].element_size()


def _host_rows(plane, lo: int, hi: int) -> torch.Tensor:
    from omni_recall_tpu_torch.index.device_index import _host_tensor

    return _host_tensor(plane[lo:hi])


def row_sharding(mesh: ShardMesh, plane, upload=None) -> RowSharded:
    """Split the leading (row) axis of ``plane`` over the mesh's shards: a
    tensor already on a shard's device gives views, anything else (a host
    numpy array or tensor, a tensor on another device) is copied to the
    shard's device (``upload(host_rows, device)``, by default
    ``Tensor.to``). Rows must divide by the global shard count; a process
    takes only its own shards' rows."""
    rows = plane.shape[0]
    s = mesh.n_shards
    if rows % s:
        raise ValueError(f"{rows} rows do not split over {s} shards")
    n_local = rows // s
    lo = mesh.shard_index(0) * n_local
    hi = lo + mesh.local_shards * n_local
    row0 = [lo + i * n_local for i in range(mesh.local_shards)]
    if upload is None:
        def upload(host, device):
            return host.to(device, copy=True)
    if isinstance(plane, torch.Tensor) and plane.device in mesh.devices:
        local = plane[lo:hi]
        shards = [local[i * n_local:(i + 1) * n_local] for i in range(mesh.local_shards)]
        shards = [x if x.device == d else upload(x, d) for x, d in zip(shards, mesh.devices)]
        return RowSharded(shards, torch.Size(plane.shape), plane.dtype, row0)
    if mesh.one_device:
        local = upload(_host_rows(plane, lo, hi), mesh.devices[0])
        shards = [local[i * n_local:(i + 1) * n_local] for i in range(mesh.local_shards)]
    else:
        shards = [upload(_host_rows(plane, lo + i * n_local, lo + (i + 1) * n_local), d)
                  for i, d in enumerate(mesh.devices)]
    return RowSharded(shards, torch.Size(plane.shape), shards[0].dtype, row0)


def replicated(mesh: ShardMesh, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` on every local shard's device (one copy a distinct device; the
    tensor itself where it already lies there)."""
    copies: dict[torch.device, torch.Tensor] = {x.device: x}
    out = []
    for d in mesh.devices:
        if d not in copies:
            copies[d] = x.to(d, non_blocking=True)
        out.append(copies[d])
    return out
