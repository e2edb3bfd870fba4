"""A panel's colour indices worked out in plain numpy: collapse, bounds, quantisation, pixels.

The arithmetic the reference spectrogram scripts define (a masked nansum
over pitch angle, 1st/99th-percentile or given colour bounds, a linear or
log10 normalisation onto the 256 colormap entries, and imshow's pixel
replication over the axes' time and energy limits), written out as float32
numpy with no cache.  It is the reference the benchmark holds the port's
PNG tiles to, and takes nothing from the port: it gets the generator's
arrays and works everything else out again.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BACKGROUND = 256  # the index of a pixel outside the data's extent (drawn white)


@dataclass(frozen=True)
class Window:
    """A contiguous run of time rows and the axis limits it is drawn across."""

    t_start: int
    t_count: int
    extent: tuple[float, float]
    xlim: tuple[float, float]


def time_window(x: np.ndarray, center: float | None = None, duration: float | None = None,
                x_min: float | None = None, x_max: float | None = None) -> Window | None:
    """The rows with ``left <= x <= right`` (both filters inclusive); None when none survive."""
    lo, hi = 0, len(x)
    zoom = center is not None and duration is not None
    if zoom:
        lo = max(lo, int(np.searchsorted(x, center - duration / 2, side="left")))
        hi = min(hi, int(np.searchsorted(x, center + duration / 2, side="right")))
    if x_min is not None:
        lo = max(lo, int(np.searchsorted(x, x_min, side="left")))
    if x_max is not None:
        hi = min(hi, int(np.searchsorted(x, x_max, side="right")))
    if hi <= lo:
        return None
    extent = (float(x[lo]), float(x[hi - 1]))
    xlim = (center - duration / 2, center + duration / 2) if zoom else extent
    return Window(lo, hi - lo, extent, xlim)


def collapse(cube: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(T, A, E) -> (T, E) float32: the sum over the masked angles, NaN counted as 0, in angle order."""
    idxs = np.flatnonzero(mask)
    acc = np.zeros((cube.shape[0], cube.shape[2]), np.float32)
    for a in idxs:
        plane = cube[:, a, :]
        acc += np.where(np.isnan(plane), np.float32(0.0), plane)
    return acc


def quantize(matrix: np.ndarray, energy: np.ndarray, y_range: tuple[float, float], window: Window,
             z_bounds: tuple[float | None, float | None], z_scale: str,
             bounds_energy_range: tuple[float, float] | None = None,
             low_pct: float = 1.0, high_pct: float = 99.0) -> dict:
    """The panel's (T, E) uint8 colour indices, the energy columns drawn, and its colour bounds.

    A missing colour bound is a percentile of the finite values in the
    panel's selection: its time window and drawn energies, or, with
    *bounds_energy_range*, every time row and the energies in that range
    (the FAST grids' rule).  On a log scale the lower bound is raised to
    the least positive value in the window; a lower bound above the upper
    is an error, as in the reference.
    """
    matrix = np.asarray(matrix, np.float32)
    energy = np.asarray(energy, np.float32)
    T, E = matrix.shape
    col_all_nan = np.all(np.isnan(matrix), axis=0)
    e_valid = (energy >= y_range[0]) & (energy <= y_range[1])
    e_keep = ~col_all_nan & e_valid
    kept = np.flatnonzero(e_keep)
    if kept.size == 0 or window.t_count <= 0:
        return {"empty": True}
    first, last = float(energy[kept[0]]), float(energy[kept[-1]])
    flip = first > last
    rows = np.zeros(T, bool)
    rows[window.t_start : window.t_start + window.t_count] = True
    vmin, vmax = z_bounds
    if vmin is None or vmax is None:
        if bounds_energy_range is not None:
            b_lo, b_hi = bounds_energy_range
            sel = np.ones(T, bool)[:, None] & (~col_all_nan & (energy >= b_lo) & (energy <= b_hi))[None, :]
        else:
            sel = rows[:, None] & e_keep[None, :]
        pool = matrix[sel & ~np.isnan(matrix)]
        lo = np.percentile(pool, low_pct) if pool.size else np.nan
        hi = np.percentile(pool, high_pct) if pool.size else np.nan
        vmin = float(lo) if vmin is None else float(vmin)
        vmax = float(hi) if vmax is None else float(vmax)
    vmin, vmax = float(vmin), float(vmax)
    posfinite = np.isfinite(matrix) & (matrix > 0)
    in_window = posfinite & rows[:, None] & e_keep[None, :]
    safe_vmin = float(matrix[in_window].min()) if in_window.any() else 1e-10
    if z_scale == "log":
        vmin = max(vmin, safe_vmin, 1e-10)
        if vmin > vmax:
            raise ValueError("minvalue must be less than or equal to maxvalue")
        idx = _indices(matrix, posfinite, "log", vmin, vmax)
    elif np.isfinite(vmin) and np.isfinite(vmax) and vmax > vmin:
        idx = _indices(matrix, posfinite, "linear", vmin, vmax)
    else:
        raise ValueError(f"degenerate linear bounds ({vmin}, {vmax}) are outside the benchmark's traffic")
    return {"empty": False, "idx": idx, "kept": kept, "flip": bool(flip), "y0": min(first, last),
            "y1": max(first, last), "vmin": vmin, "vmax": vmax, "window": window}


def _indices(matrix: np.ndarray, posfinite: np.ndarray, z_scale: str, vmin: float, vmax: float) -> np.ndarray:
    """floor(256 * normalised value), clipped to 0..255, in float32 as the reference's imshow does it."""
    if vmin == vmax:
        return np.zeros(matrix.shape, np.uint8)
    with np.errstate(invalid="ignore", divide="ignore"):
        if z_scale == "log":
            lg = np.log10(np.maximum(matrix, np.float32(1e-37)))
            lg = np.where(posfinite, lg, np.log10(np.float32(vmin)))
            span = np.float32(np.log10(vmax) - np.log10(vmin))
            norm = (lg - np.float32(np.log10(vmin))) / (span if span != 0 else np.float32(1.0))
        else:
            work = np.where(np.isposinf(matrix), np.float32(vmax), matrix)
            work = np.where(np.isnan(work) | np.isneginf(work), np.float32(vmin), work)
            span = np.float32(vmax - vmin)
            norm = (work - np.float32(vmin)) / (span if span != 0 else np.float32(1.0))
    if np.isnan(span):
        return np.zeros(matrix.shape, np.uint8)
    return np.clip(np.floor(norm * np.float32(256.0)), 0, 255).astype(np.uint8)


def x_map(window: Window, width: int) -> np.ndarray:
    """(a, b) with ``a * px + b`` the matrix row, relative to the window, under pixel column *px*."""
    ex0, ex1 = window.extent
    xl0, xl1 = window.xlim
    n = window.t_count
    if ex1 == ex0:
        return np.array([0.0, 0.5], dtype=np.float32)
    a = n * (xl1 - xl0) / ((ex1 - ex0) * width)
    b = n * ((xl0 - ex0) + 0.5 * (xl1 - xl0) / width) / (ex1 - ex0)
    return np.array([a, b], dtype=np.float32)


def tile(q: dict, height: int, width: int, y_scale: str) -> np.ndarray:
    """The (height, width) colour indices of the drawn tile, top row first; BACKGROUND outside the data."""
    if q["empty"]:
        return np.full((height, width), BACKGROUND, np.int16)
    idx, kept, window = q["idx"], q["kept"], q["window"]
    T, E = idx.shape
    n_kept = kept.size
    xm = x_map(window, width)
    col_f = xm[0] * np.arange(width, dtype=np.float32) + xm[1]
    x_ok = (col_f >= 0.0) & (col_f <= np.float32(window.t_count))
    col = np.clip(col_f.astype(np.int32), 0, max(window.t_count - 1, 0))
    t_idx = np.clip(window.t_start + col, 0, T - 1)

    py = ((np.arange(height, dtype=np.float32) + np.float32(0.5)) / np.float32(height)).astype(np.float32)
    nk = np.float32(n_kept)
    y0, y1 = q["y0"], q["y1"]
    if y_scale == "log":
        ly0 = np.log10(np.maximum(np.float32(y0), np.float32(1e-37)))
        ly1 = np.log10(np.maximum(np.float32(y1), np.float32(1e-37)))
        y_data = np.power(np.float32(10.0), ly0 + py * (ly1 - ly0)).astype(np.float32)
        denom = np.float32(1.0) if y1 == y0 else np.float32(y1) - np.float32(y0)
        row_f = (y_data - np.float32(y0)) / denom * nk
    else:
        row_f = py * nk
    row = np.clip(row_f.astype(np.int32), 0, n_kept - 1)
    if q["flip"]:
        row = n_kept - 1 - row
    e_idx = kept[np.clip(row, 0, E - 1)][::-1]  # top pixel row first
    out = idx[np.ix_(t_idx, e_idx)].T.astype(np.int16)
    out[:, ~x_ok] = BACKGROUND
    return out
