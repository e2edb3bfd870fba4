"""Host-side preparation of device rasterization inputs.

The time axis lives on the host (it is needed for tick labels anyway), so
zoom-window and x-clip selection resolve here to a contiguous
``(t_start, t_count)`` window plus an affine pixel->matrix-column map; the
device never sees dynamic shapes.  Mirrors the row-filtering steps of the
reference's ``make_spectrogram`` (reference plotting.py:204-219,238-253).

A copy of the JAX package's ``render/tile.py``: the run blit goes through
the native kernel (:func:`..render.fastpng.blit_runs`, byte-identical to
the numpy tail), and the numpy tail runs only for a layout the kernel does
not take.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TimeWindow:
    """A resolved contiguous time selection and its plot coordinates."""

    t_start: int
    t_count: int
    extent: tuple[float, float]  # first/last selected x value
    xlim: tuple[float, float]  # drawn axis limits (may exceed extent)


def compute_time_window(
    x: np.ndarray,
    center: float | None = None,
    duration_seconds: float | None = None,
    x_min: float | None = None,
    x_max: float | None = None,
) -> TimeWindow | None:
    """Resolve zoom/x-clip filtering to a contiguous index window.

    Matches the reference's two inclusive-bound mask filters
    (``(x >= left) & (x <= right)``, reference plotting.py:204-219) via
    searchsorted on the sorted time array.  Returns ``None`` when nothing
    survives (the reference's empty-plot skip path).
    """
    x = np.asarray(x)
    lo, hi = 0, len(x)
    zoom = center is not None and duration_seconds is not None
    if zoom:
        left = center - duration_seconds / 2
        right = center + duration_seconds / 2
        lo = max(lo, int(np.searchsorted(x, left, side="left")))
        hi = min(hi, int(np.searchsorted(x, right, side="right")))
    if x_min is not None:
        lo = max(lo, int(np.searchsorted(x, x_min, side="left")))
    if x_max is not None:
        hi = min(hi, int(np.searchsorted(x, x_max, side="right")))
    if hi <= lo:
        return None
    extent = (float(x[lo]), float(x[hi - 1]))
    if zoom:
        xlim = (center - duration_seconds / 2, center + duration_seconds / 2)
    else:
        xlim = extent
    return TimeWindow(t_start=lo, t_count=hi - lo, extent=extent, xlim=xlim)


def pixel_columns(
    x_map: np.ndarray, t_start: int, t_count: int, n_time: int, out_w: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-pixel-column matrix row indices and in-extent mask (float32 math).

    The single source of truth for the pixel->time-row mapping, shared by
    host resampling and the device-side pre-gather (their arithmetic must
    agree bit-for-bit).
    """
    xm = np.asarray(x_map, np.float32)
    px = np.arange(out_w, dtype=np.float32)
    col_f = xm[0] * px + xm[1]
    x_ok = (col_f >= 0.0) & (col_f <= np.float32(t_count))
    col = np.clip(col_f.astype(np.int32), 0, max(t_count - 1, 0))
    return np.clip(t_start + col, 0, n_time - 1), x_ok


def resample_indices(
    idx: np.ndarray,
    kept_pos: np.ndarray,
    n_kept: int,
    flip: bool,
    y0: float,
    y1: float,
    t_start: int,
    t_count: int,
    x_map: np.ndarray,
    out_h: int,
    out_w: int,
    y_scale: str,
    lut: np.ndarray,
    bg_rgba: tuple[int, int, int, int] = (255, 255, 255, 255),
    empty: bool = False,
    pre_gathered: bool = False,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Pixel-replicate a quantized (T, E) index matrix to an RGBA tile.

    The numpy mirror of the device resampling in
    :func:`configurable_spectrograms_torch.ops.spectrogram.render_matrix`
    (same float32 arithmetic, so outputs are bit-identical); used on the
    readback-light production path where the device ships only the small
    index matrix.  With ``pre_gathered`` the device already gathered one
    matrix row per pixel column (row i == pixel column i); out-of-extent
    columns still mask to background here.  Returns (out_h, out_w, 4)
    uint8 in PNG row order -- or, with ``out`` (an RGBA view no larger
    than (out_h, out_w), e.g. a figure-canvas rect), writes the tile's
    top-left overlap directly into it and returns ``out``, skipping the
    intermediate tile allocation entirely (the run rows broadcast
    straight into the destination).
    """
    lut_ext = np.concatenate([np.asarray(lut, np.uint8), np.asarray([bg_rgba], np.uint8)], axis=0)
    if empty or n_kept <= 0 or t_count <= 0 or out_h <= 0 or out_w <= 0:
        if out is not None:
            out[...] = lut_ext[256]
            return out
        return np.broadcast_to(lut_ext[256], (max(out_h, 0), max(out_w, 0), 4)).copy()
    T, E = idx.shape
    if pre_gathered:
        t_idx = np.arange(out_w, dtype=np.int32)
        _, x_ok = pixel_columns(x_map, t_start, t_count, max(T, t_count), out_w)
    else:
        t_idx, x_ok = pixel_columns(x_map, t_start, t_count, T, out_w)

    py = ((np.arange(out_h, dtype=np.float32) + np.float32(0.5)) / np.float32(out_h)).astype(np.float32)
    nk = np.float32(max(n_kept, 1))
    if y_scale == "log":
        ly0 = np.log10(np.maximum(np.float32(y0), np.float32(1e-37)))
        ly1 = np.log10(np.maximum(np.float32(y1), np.float32(1e-37)))
        y_data = np.power(np.float32(10.0), ly0 + py * (ly1 - ly0)).astype(np.float32)
        denom = np.float32(1.0) if y1 == y0 else np.float32(y1) - np.float32(y0)
        row_f = (y_data - np.float32(y0)) / denom * nk
    else:
        row_f = py * nk
    row = np.clip(row_f.astype(np.int32), 0, max(n_kept - 1, 0))
    row_eff = (n_kept - 1 - row) if flip else row
    e_idx = np.asarray(kept_pos)[np.clip(row_eff, 0, E - 1)]

    # Output rows come in contiguous runs that repeat one energy row each
    # (out_h >> n_kept): resolve the <= n_kept distinct runs FIRST, gather
    # just those uint8 index rows, color them straight into a contiguous
    # (n_runs, out_w, 4) block, and expand whole RGBA rows with
    # ``np.repeat`` (contiguous memcpys).  Coloring after run selection
    # skips both the full (out_w, E) RGBA slab and its cache-hostile
    # transpose (~40% faster than the slab order at 200 DPI,
    # bit-identical output).
    row_src = e_idx[::-1]  # (out_h,) energy row per output row, top first
    boundaries = np.flatnonzero(np.diff(row_src)) + 1
    starts = np.concatenate(([0], boundaries))
    counts = np.diff(np.concatenate((starts, [out_h])))
    sel = row_src[starts]  # (n_runs,) energy columns actually drawn

    # Native one-pass tail: gather + LUT colour + run replication in one
    # C++ walk straight into the destination (integer and uint8 operations
    # only, so bit-identical to the numpy tail below).  The geometry above
    # stays in float32 numpy so host and device mappings agree bit for bit.
    from configurable_spectrograms_torch.render import fastpng

    dest = out if out is not None else np.empty((out_h, out_w, 4), np.uint8)
    if fastpng.blit_runs(idx, t_idx, x_ok, sel, starts, counts, lut_ext, dest):
        return dest

    # Single fused gather: two chained gathers materialize an (n_runs, T)
    # intermediate, ~3x slower than the slab order on the host backend's
    # full-length records (T >> out_w); np.ix_ is faster in BOTH regimes.
    gi = idx.T[np.ix_(sel, t_idx)]  # (n_runs, out_w) uint8 indices
    rows = lut_ext[gi]  # (n_runs, out_w, 4) colored, contiguous
    if not x_ok.all():
        rows[:, ~x_ok] = lut_ext[256]
    if out is not None:
        oh, ow = out.shape[0], out.shape[1]
        for k in range(len(sel)):
            s = int(starts[k])
            if s >= oh:
                break
            out[s : min(s + int(counts[k]), oh)] = rows[k, :ow]
        return out
    return np.repeat(rows, counts, axis=0)


def make_x_map(window: TimeWindow, width: int) -> np.ndarray:
    """Affine map ``col_f = a*px + b`` from output pixel column to matrix row.

    ``px`` is the integer pixel index; the half-pixel center offset is baked
    into ``b``.  Encodes both the xlim->data transform and imshow's extent
    pixel replication, so the device kernel only evaluates one fma per
    column.
    """
    ex0, ex1 = window.extent
    xl0, xl1 = window.xlim
    n = window.t_count
    if ex1 == ex0:
        # Single-sample window: the one sample fills the panel.
        return np.array([0.0, 0.5], dtype=np.float32)
    a = n * (xl1 - xl0) / ((ex1 - ex0) * width)
    b = n * ((xl0 - ex0) + 0.5 * (xl1 - xl0) / width) / (ex1 - ex0)
    return np.array([a, b], dtype=np.float32)
