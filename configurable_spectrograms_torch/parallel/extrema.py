"""Collective folder-wide extrema statistics over a mesh of ranks (port of ``parallel/extrema.py``).

Files shard over the mesh's ``data`` axis and (optionally) each file's
time rows over a ``time`` axis.  Each rank reduces its block with the
collapse kernel (:func:`..ops.extrema_ops.file_extrema_stats_lanes`: all
pitch bins, one launch) to per-energy-bin positive counts and a log
histogram.  One ``all_reduce`` sum over the whole mesh then completes
everything: each rank adds its partial counts into its own files' rows of
a zero-filled (N, E) buffer (ranks along ``time`` add into the same rows,
which sums a file's time shards) followed by its histogram, so every rank
returns the full per-file counts and the global histogram, as the JAX
module's ``psum`` and ``process_allgather`` do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from configurable_spectrograms_torch.ops.extrema_ops import HIST_BINS, file_extrema_stats_lanes
from configurable_spectrograms_torch.parallel.mesh import FileShard, shard_block
from configurable_spectrograms_torch.utils.torch_setup import get_device


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the rank's card under NCCL, the CPU under Gloo."""
    return get_device() if dist.get_backend() == "nccl" else torch.device("cpu")


def _check_mesh(mesh) -> None:
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh spans {mesh.size()} ranks; the group has {dist.get_world_size()}")


def _local_shard(cubes, t_valids, mesh) -> FileShard:
    """This rank's block of the global batch *cubes* (any array that numpy-slices; only the block is read)."""
    N, T = cubes.shape[:2]
    files, rows = shard_block(mesh, N, T)
    device = get_device()
    if isinstance(cubes, torch.Tensor):
        block = cubes[files, rows].to(device=device, dtype=torch.float32).contiguous()
    else:
        block = torch.from_numpy(np.ascontiguousarray(cubes[files, rows], np.float32)).to(device)
    tv = torch.as_tensor(np.asarray(t_valids, np.int32)[files]).to(device)
    return FileShard(block, tv, files.start, N, rows.start)


def sharded_extrema_stats(cubes, t_valids, mesh) -> tuple[np.ndarray, np.ndarray]:
    """Global extrema stats for a batch of files sharded over *mesh*.

    Parameters
    ----------
    cubes : (N, T, A, E) float32, or a :class:`..parallel.mesh.FileShard`
        The padded global batch (numpy, a memory map or a tensor; each rank
        reads only its block), N a multiple of the ``data`` axis and T of
        the ``time`` axis (pad rows with NaN); or this rank's block,
        already on its device (``t_valids`` then None).
    t_valids : (N,) int32
        Real time length per file.
    mesh : DeviceMesh
        A mesh over the whole group with a ``data`` axis and optionally a
        ``time`` axis (:func:`..parallel.mesh.make_mesh`).

    Returns
    -------
    (counts, hist)
        ``counts`` (N, E) int32 per-file positive samples per energy bin;
        ``hist`` (HIST_BINS,) int64 global log-histogram; the same on
        every rank.
    """
    _check_mesh(mesh)
    if isinstance(cubes, FileShard):
        if t_valids is not None:
            raise ValueError("a FileShard carries its t_valids; pass t_valids=None")
        shard = cubes
    else:
        shard = _local_shard(cubes, t_valids, mesh)
    n, t_shard, _, E = shard.cubes.shape
    # A time shard's cut-off: the file's real rows that fall in this shard.
    local_tv = torch.clamp(shard.t_valids.to(torch.int64) - shard.t_offset, 0, t_shard).to(torch.int32)
    stats = file_extrema_stats_lanes(shard.cubes, local_tv)
    N = shard.n_files
    buf = torch.zeros((N * E + HIST_BINS,), dtype=torch.int64, device=shard.cubes.device)
    lo = shard.file_offset * E
    buf[lo: lo + n * E] = stats["counts"].reshape(-1).to(torch.int64)
    buf[N * E:] = stats["hist"].to(torch.int64).sum(dim=0)
    buf = buf.to(collective_device())
    dist.all_reduce(buf)
    out = buf.cpu().numpy()
    return out[: N * E].reshape(N, E).astype(np.int32), out[N * E:].astype(np.int64)
