"""Sharded batch rasterization over a mesh of ranks (port of ``parallel/sharding.py``).

The render path is embarrassingly parallel across panels: each rank
renders its contiguous share of the panel batch along the mesh's ``data``
axis on its own card (the collapse kernel, one launch for the share, then
:func:`..ops.spectrogram.render_matrix`), and one ``all_reduce`` sum
hands every rank the whole batch's results.  The sum runs on the results'
bits as int32: each panel's row is filled by exactly one rank (the ranks
along any other axis hold the same share and add zeros), so the sum is a
copy, bit for bit, NaNs and signed zeros included.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from configurable_spectrograms_torch.ops.kernels import collapse_lanes
from configurable_spectrograms_torch.ops.spectrogram import RenderSpec, render_matrix
from configurable_spectrograms_torch.parallel.extrema import _check_mesh, collective_device
from configurable_spectrograms_torch.parallel.mesh import _coordinate
from configurable_spectrograms_torch.utils.torch_setup import get_device

#: The result keys of :func:`..ops.spectrogram.render_matrix`, in the packed buffer's order.
_KEYS = ("rgba", "vmin", "vmax", "y0", "y1", "n_kept", "empty")


def _as_int32(t: torch.Tensor) -> torch.Tensor:
    """A result as int32 words per panel: float32 by its bits, integers and bools by value."""
    t = t.contiguous()
    if t.dtype == torch.float32:
        t = t.view(torch.int32)
    return t.to(torch.int32).reshape(t.shape[0], -1)


def _from_int32(words: np.ndarray, like: torch.Tensor) -> np.ndarray:
    shape = (words.shape[0], *like.shape[1:])
    if like.dtype == torch.float32:
        return np.ascontiguousarray(words).view(np.float32).reshape(shape)
    dtype = {torch.uint8: np.uint8, torch.bool: np.bool_, torch.int32: np.int32}[like.dtype]
    return words.astype(dtype).reshape(shape)


def sharded_batch_render(
    mesh,
    spec: RenderSpec,
    cubes: np.ndarray,
    pitch_masks: np.ndarray,
    t_valids: np.ndarray,
    energies: np.ndarray,
    e_valids: np.ndarray,
    t_starts: np.ndarray,
    t_counts: np.ndarray,
    x_maps: np.ndarray,
    z_bounds: np.ndarray,
    luts: np.ndarray,
    out_h: int | None = None,
    out_w: int | None = None,
) -> dict[str, np.ndarray]:
    """Rasterize a panel batch sharded over the mesh's ``data`` axis.

    The leading (panel) dimension of every argument must be a multiple of
    the ``data`` axis size -- pad with dummy panels (``t_counts=0`` renders
    background) and slice the results.  Returns host numpy arrays, the
    whole batch on every rank.
    """
    _check_mesh(mesh)
    n = cubes.shape[0]
    d, data_size = _coordinate(mesh, "data")
    if n % data_size != 0:
        raise ValueError(f"panel batch ({n}) must be a multiple of the data axis ({data_size})")
    names = mesh.mesh_dim_names or ()
    contributes = all(c == 0 for name, c in zip(names, mesh.get_coordinate()) if name != "data")
    nl = n // data_size
    mine = slice(d * nl, (d + 1) * nl)
    device = get_device()

    def local(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[mine], dtype)).to(device)

    m = collapse_lanes(local(cubes, np.float32), torch.arange(nl, dtype=torch.int32, device=device),
                       local(pitch_masks, np.bool_), local(t_valids, np.int32))
    out = render_matrix(
        m, local(energies, np.float32), local(e_valids, np.bool_), local(t_valids, np.int32),
        local(t_starts, np.int32), local(t_counts, np.int32), local(x_maps, np.float32),
        local(z_bounds, np.float32), local(luts, np.uint8), spec,
        out_h=torch.full((nl,), spec.height if out_h is None else out_h, dtype=torch.int32, device=device),
        out_w=torch.full((nl,), spec.width if out_w is None else out_w, dtype=torch.int32, device=device),
    )
    parts = [_as_int32(out[k]) for k in _KEYS]
    widths = [p.shape[1] for p in parts]
    buf = torch.zeros((n, sum(widths)), dtype=torch.int32, device=device)
    if contributes:
        buf[mine] = torch.cat(parts, dim=1)
    buf = buf.to(collective_device())
    dist.all_reduce(buf)
    words = buf.cpu().numpy()
    result, col = {}, 0
    for k, w in zip(_KEYS, widths):
        result[k] = _from_int32(words[:, col: col + w], out[k])
        col += w
    return result
