"""Process groups, device meshes and per-rank file shards (port of ``parallel/mesh.py``).

The JAX package drives every local chip from one process and shards over
a ``Mesh`` of devices.  The port runs one process per GPU, as
``torchrun --nproc-per-node N`` starts it: rank ``r`` computes only on
``cuda:{LOCAL_RANK}``, and a mesh is a ``torch.distributed`` ``DeviceMesh``
over the ranks of the process group.  The collectives of
:mod:`.extrema` and :mod:`.sharding` are ``all_reduce`` sums only, on
tensors that sit on the backend's own device (the rank's GPU under NCCL,
the CPU under Gloo).

Hosts (ranks) partition an archive at the orbit level
(``fast/batch_directory._shard_orbits_across_processes``); within a rank
the render path runs on its one card.  None of the JAX module's link
probing comes over: a PCIe-attached card needs none.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

#: This process's identity in a multi-process run, recorded by
#: :func:`init_distributed` (or :func:`set_process_shard`).  ``local_rank``
#: is the index of the card this rank computes on; ``None`` outside a
#: group that :func:`init_distributed` set up.
_DISTRIBUTED: dict = {"process_id": 0, "num_processes": 1, "local_rank": None}


def process_group_ready() -> bool:
    """Whether this process is in an initialised ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the process group: one rank per GPU, bound to its own card.

    Arguments left out come from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``: ``init_method="env://"``);
    *coordinator_address* ``host:port`` becomes ``tcp://host:port``.
    *backend* defaults to NCCL when the port's device is CUDA and to Gloo
    on the CPU; a backend that fails to initialise raises (nothing is
    switched silently).  On a card, the rank first makes
    ``cuda:{LOCAL_RANK}`` its current device (``LOCAL_RANK`` defaults to
    the rank), and :func:`..utils.torch_setup.get_device` returns that
    device from then on.
    """
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    device = get_device()
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    rank_hint = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", rank_hint))
    if device.type == "cuda":
        if not 0 <= local_rank < torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK {local_rank} names no card: {torch.cuda.device_count()} visible")
        torch.cuda.set_device(local_rank)
    kwargs = {"backend": backend}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)
    _DISTRIBUTED.update(process_id=int(dist.get_rank()), num_processes=int(dist.get_world_size()),
                        local_rank=local_rank)


def shutdown_distributed() -> None:
    """Destroy the process group, if any, and forget this process's rank."""
    if process_group_ready():
        dist.destroy_process_group()
    _DISTRIBUTED.update(process_id=0, num_processes=1, local_rank=None)


def local_device_index() -> int | None:
    """The card index :func:`init_distributed` bound this rank to (``None`` outside such a group)."""
    return _DISTRIBUTED["local_rank"]


def process_shard_info() -> tuple[int, int]:
    """``(process_id, num_processes)``: the group's rank and size once a group exists, else the recorded pair."""
    if process_group_ready():
        return dist.get_rank(), dist.get_world_size()
    return _DISTRIBUTED["process_id"], _DISTRIBUTED["num_processes"]


def set_process_shard(process_id: int, num_processes: int) -> None:
    """Record multi-process identity for callers that bypassed init_distributed."""
    _DISTRIBUTED["process_id"] = int(process_id)
    _DISTRIBUTED["num_processes"] = int(num_processes)


def _mesh_device_type() -> str:
    """``cuda`` under NCCL, ``cpu`` under Gloo: where the group's collectives run."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_parallel_mesh():
    """A one-axis ``('data',)`` mesh over the whole group; ``None`` with no group or one rank."""
    if not process_group_ready() or dist.get_world_size() < 2:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (dist.get_world_size(),), mesh_dim_names=("data",))


def make_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, ...] = ("data",),
    axis_sizes: tuple[int, ...] | None = None,
):
    """A ``DeviceMesh`` of *axis_sizes* named *axis_names* over the group's ranks.

    One rank is one device.  ``axis_sizes`` defaults to putting every rank
    on the first axis.  Asking for more devices than there are ranks, or
    axis sizes that do not multiply to ``n_devices``, raises the JAX
    module's ``ValueError``; a mesh spans the whole group, so fewer raises
    too.  Outside a group there is one rank, and a mesh needs a group:
    call :func:`init_distributed` first.
    """
    available = dist.get_world_size() if process_group_ready() else 1
    if n_devices is None:
        n_devices = available
    if n_devices > available:
        raise ValueError(f"requested {n_devices} devices but only {available} available")
    if axis_sizes is None:
        axis_sizes = (n_devices,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n_devices:
        raise ValueError(f"axis sizes {axis_sizes} do not multiply to {n_devices}")
    if n_devices != available:
        raise ValueError(f"a mesh spans every rank of the group: {n_devices} requested, {available} ranks")
    if not process_group_ready():
        raise RuntimeError("make_mesh needs a process group: call init_distributed() first")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of *m* that is >= *n* (and >= m)."""
    return max(m, ((n + m - 1) // m) * m)


def _coordinate(mesh, axis: str) -> tuple[int, int]:
    """(this rank's index along *axis*, the axis size); (0, 1) for an axis the mesh lacks."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 0, 1
    return mesh.get_local_rank(axis), mesh.size(names.index(axis))


@dataclass(frozen=True)
class FileShard:
    """This rank's block of a global (N, T, A, E) file batch, on the rank's device.

    ``cubes`` (n_local, T_shard, A, E) float32 holds files
    ``[file_offset, file_offset + n_local)`` and time rows
    ``[t_offset, t_offset + T_shard)``; ``t_valids`` (n_local,) int32 are
    those files' real lengths in global rows.  ``n_files`` is N.
    """

    cubes: torch.Tensor
    t_valids: torch.Tensor
    file_offset: int
    n_files: int
    t_offset: int


def shard_block(mesh, n_files: int, n_time: int) -> tuple[slice, slice]:
    """(files, time rows) of the global batch that this rank holds on *mesh*.

    Files split in contiguous runs over ``data``, rows over ``time``; N
    must divide by the ``data`` axis and T by the ``time`` axis.
    """
    d, d_size = _coordinate(mesh, "data")
    t, t_size = _coordinate(mesh, "time")
    if n_files % d_size or n_time % t_size:
        raise ValueError(f"batch ({n_files} files x {n_time} rows) must divide by the mesh axes "
                         f"(data {d_size}, time {t_size})")
    nl, tl = n_files // d_size, n_time // t_size
    return slice(d * nl, (d + 1) * nl), slice(t * tl, (t + 1) * tl)


def global_file_batch(local_cubes, local_t_valids, mesh) -> FileShard:
    """This rank's :class:`FileShard` from its process-local file stack.

    The counterpart of the JAX function: every process passes the
    ``(n_local, T, A, E)`` stack of the files at its ``data`` coordinate
    (the ranks along ``time`` pass the same stack), and keeps its block on
    its own device: its time rows, the global file offset and the global
    count ``n_local * data``.  Pad the local stack with NaN cubes
    (``t_valid=0``) so every process contributes the same count.
    """
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    d, d_size = _coordinate(mesh, "data")
    n_local, T = local_cubes.shape[:2]
    _, rows = shard_block(mesh, n_local * d_size, T)
    device = get_device()
    return FileShard(
        cubes=torch.as_tensor(np.ascontiguousarray(local_cubes[:, rows], np.float32)).to(device),
        t_valids=torch.as_tensor(np.ascontiguousarray(local_t_valids, np.int32)).to(device),
        file_offset=d * n_local,
        n_files=n_local * d_size,
        t_offset=rows.start,
    )
