"""Host (numpy) implementation of the collapse+quantize panel analysis.

A copy of the JAX package's ``render/host_quantize.py``: the float32 numpy
mirror of :func:`configurable_spectrograms_torch.ops.spectrogram._analyze_matrix`.
It is the ``CST_RENDER_BACKEND=host`` backend, the golden-figure path, and
the oracle the device backend is compared with (same masking, percentile,
normalisation and quantisation rules).
"""

from __future__ import annotations

import numpy as np

from configurable_spectrograms_torch.ops.exact_percentile import (
    numpy_lerp_percentile,
    percentile_ranks,
)
from configurable_spectrograms_torch.utils.resident_cache import ResidentCache

#: Cross-render collapse cache: a batch renders each cube's category
#: collapses many times (raw + given-extrema figure pairs, repeat passes)
#: and the (T, E) matrices are small (~400 KB) next to the 12.6 MB cubes,
#: so they stay resident keyed by (id(cube), mask bytes); owner-death
#: eviction keeps a recycled id from aliasing a stale entry.  FIFO-capped
#: at ~4 category masks x ~60 in-flight cubes.
_COLLAPSE_CACHE = ResidentCache(max_entries=256)

#: Percentile color-bound cache.  The pool extraction + sort is ~70% of a
#: panel's quantize cost, and identical pools recur constantly: a pitch
#: grid's full and zoom panels share full-time bounds, and the four scale
#: combos of a batch share them too (the pool does not depend on the
#: z scale).  Keyed by the selection signature with the matrix as owner.
_BOUNDS_CACHE = ResidentCache(max_entries=256)

#: Per-matrix derived masks (all-NaN columns, positive-finite entries,
#: log10 tables, safe-vmin scalars).  Every panel of a figure -- and every
#: repeat render of a cached collapse matrix -- recomputes the same
#: isnan/isfinite/log10 passes; the matrices are shared objects from
#: :data:`_COLLAPSE_CACHE`, so the results stay resident keyed by
#: ``id(matrix)`` with the matrix as owner.  A batch window holds ~4
#: derived keys per matrix and ~4 matrices per cube (pitch categories), so
#: the bound covers ~60 in-flight cubes (~0.5 MB of derived arrays per
#: matrix); owner-death eviction keeps long streams from pinning memory.
_MASK_CACHE = ResidentCache(max_entries=1024)

#: Quantized-index cache.  The final ``idx`` matrix depends only on the
#: matrix values, the z scale, and the FINAL (vmin, vmax) -- the selection
#: window feeds those scalars (safe-positive floor, linear fallback
#: bounds) but never the elementwise mapping, which always runs over the
#: full matrix.  A pitch grid's full and zoom panels, the raw and
#: given-extrema renders of a batch, and repeat passes therefore all map
#: to identical idx matrices; one uint8 (T, E) entry is ~100 KB.
_IDX_CACHE = ResidentCache(max_entries=512)


def _matrix_masks(matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(col_all_nan (E,), positive_finite (T, E))`` for a shared matrix.

    Cached by identity; falls back to direct computation for matrices that
    are not long-lived shared objects (callers that converted dtype).
    """
    key = ("masks", id(matrix))
    hit = _MASK_CACHE.get(key)
    if hit is not None:
        return hit
    col_all_nan = np.all(np.isnan(matrix), axis=0)
    posfinite = np.isfinite(matrix) & (matrix > 0)
    return _MASK_CACHE.insert(key, (col_all_nan, posfinite), (matrix,))


def _log10_table(matrix: np.ndarray) -> np.ndarray:
    """``log10(maximum(matrix, 1e-37))`` resident per shared matrix.

    Entries that the log mapping replaces anyway (NaN / +inf) pass through
    as NaN / +inf and are overwritten by the caller's ``where``; every
    kept entry is bit-identical to the uncached chain because ``where``
    routes the original value through the same ``maximum``+``log10``.
    """
    key = ("log10", id(matrix))
    hit = _MASK_CACHE.get(key)
    if hit is not None:
        return hit
    with np.errstate(invalid="ignore", divide="ignore"):
        table = np.log10(np.maximum(matrix, np.float32(1e-37)))
    return _MASK_CACHE.insert(key, table, (matrix,))


def _linear_masks(matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(nan_or_neginf, posinf)`` masks resident per shared matrix."""
    key = ("linmask", id(matrix))
    hit = _MASK_CACHE.get(key)
    if hit is not None:
        return hit
    to_vmin = np.isnan(matrix) | np.isneginf(matrix)
    to_vmax = np.isposinf(matrix)
    return _MASK_CACHE.insert(key, (to_vmin, to_vmax), (matrix,))


def _quantized_idx(
    matrix: np.ndarray,
    posfinite: np.ndarray,
    z_scale: str,
    vmin: float,
    vmax: float,
) -> np.ndarray:
    """The (T, E) uint8 colormap-index matrix for final bounds.

    The elementwise mapping runs over the FULL matrix and depends only on
    (values, z scale, final vmin/vmax) -- the panel's time/energy window
    feeds the *scalars* upstream but never this map -- so full and zoom
    panels, raw and given-extrema renders, and repeat passes share one
    entry.  Each arm mirrors the reference normalization bit-for-bit
    (pinned by the golden figures and tests/test_reference_parity.py).
    """
    key = (id(matrix), z_scale, float(vmin), float(vmax))
    hit = _IDX_CACHE.get(key)
    if hit is not None:
        return hit
    if vmin == vmax:
        # matplotlib's Normalize fills 0 for EVERY cell when vmin == vmax
        # (reference plotting.py feeds LogNorm / the vmin=/vmax= kwargs, so
        # an equal-bounds panel -- constant-data extrema, equal percentile
        # qs -- renders entirely LUT[0], NaNs included: the reference
        # substitutes them with vmin before imshow).
        idx = np.zeros(matrix.shape, np.uint8)
        return _IDX_CACHE.insert(key, idx, (matrix,))
    if z_scale == "log":
        # Substituted entries must equal log10f32(float32(vmin)) exactly as
        # the uncached chain produced them (float32 ufunc loop), while the
        # subtrahend keeps the reference's float64->float32 cast.
        bad = ~posfinite
        lg_elem = np.log10(np.float32(vmin))
        span = np.float32(np.log10(vmax) - np.log10(vmin))
        norm = (np.where(bad, lg_elem, _log10_table(matrix)) - np.float32(np.log10(vmin))) / (
            span if span != 0 else np.float32(1.0)
        )
    else:
        to_vmin, to_vmax = _linear_masks(matrix)
        work = np.where(to_vmax, np.float32(vmax), np.where(to_vmin, np.float32(vmin), matrix))
        span = np.float32(vmax - vmin)
        norm = (work - np.float32(vmin)) / (span if span != 0 else np.float32(1.0))
    if np.isnan(span):
        # Log-z bounds go NaN when the percentile lerp hits an inf-inf pool
        # (numpy's percentile does the same) or an explicit NaN/negative
        # vmax survives to log10; a NaN span NaNs every cell of norm.  Pin
        # the whole panel to LUT[0] -- the NaN->uint8 cast this used to
        # rely on is platform-defined (0 on x86/ARM, but not guaranteed).
        idx = np.zeros(matrix.shape, np.uint8)
    else:
        idx = np.clip(np.floor(norm * np.float32(256.0)), 0, 255).astype(np.uint8)
    return _IDX_CACHE.insert(key, idx, (matrix,))


def cached_collapse(cube: np.ndarray, pitch_mask: np.ndarray, clean_provider=None) -> np.ndarray:
    """:func:`host_collapse` with a cross-render resident-result cache.

    *clean_provider* is an optional zero-arg callable returning the
    :func:`host_clean` array; it is invoked only on a cache miss, so the
    shared NaN pass is skipped entirely when every mask of a cube hits.
    Returned matrices are shared -- callers must not mutate them.
    """
    key = (id(cube), pitch_mask.tobytes())
    hit = _COLLAPSE_CACHE.get(key)
    if hit is not None:
        return hit
    matrix = host_collapse(cube, pitch_mask, clean_provider() if clean_provider else None)
    return _COLLAPSE_CACHE.insert(key, matrix, (cube,))


def host_clean(cube: np.ndarray) -> np.ndarray:
    """NaN-zeroed copy of a cube, shareable across that cube's pitch masks.

    A figure's panels collapse one cube under several category masks; doing
    the NaN pass once per cube instead of once per panel cuts the collapse
    stage ~2.6x (bit-identical results).
    """
    return np.where(np.isnan(cube), np.float32(0.0), cube)


def host_collapse(
    cube: np.ndarray, pitch_mask: np.ndarray, clean: np.ndarray | None = None
) -> np.ndarray:
    """Masked nansum collapse (T, A, E) -> (T, E), float32.

    *clean* (from :func:`host_clean`) lets callers amortize the NaN pass
    over multiple masks of the same cube.  Accumulates the selected angle
    slices sequentially in index order -- numpy's own reduction order for
    a non-contiguous axis, so results are bit-identical to
    ``clean[:, mask, :].sum(axis=1)`` while skipping that path's large
    gather temporary (~4x faster at FAST dimensions).
    """
    if clean is None:
        clean = host_clean(cube)
    idxs = np.flatnonzero(pitch_mask)
    if idxs.size == 0:
        return np.zeros((cube.shape[0], cube.shape[2]), np.float32)
    acc = np.array(clean[:, idxs[0], :], np.float32, copy=True)
    for a in idxs[1:]:
        np.add(acc, clean[:, a, :], out=acc)
    return acc


def host_quantize(
    matrix: np.ndarray,
    energy: np.ndarray,
    e_valid: np.ndarray,
    t_start: int,
    t_count: int,
    z_bounds: tuple[float | None, float | None],
    y_scale: str,
    z_scale: str,
    low_pct: float,
    high_pct: float,
    zb_e_valid: np.ndarray | None = None,
    zb_full_time: bool = False,
) -> dict:
    """Numpy mirror of the device panel analysis (unpadded shapes).

    Returns the same fields the device path ships: ``idx`` (T, E) uint8,
    ``kept_pos``, ``n_kept``, ``flip``, ``y0``, ``y1``, ``vmin``, ``vmax``,
    ``empty``.
    """
    matrix = np.asarray(matrix, np.float32)
    energy = np.asarray(energy, np.float32)
    T, E = matrix.shape

    col_all_nan, posfinite = _matrix_masks(matrix)
    e_keep = (~col_all_nan) & e_valid
    kept_pos = np.flatnonzero(e_keep).astype(np.int32)
    n_kept = int(kept_pos.size)
    empty = n_kept == 0 or t_count <= 0
    if empty:
        return {
            "idx": np.zeros((T, E), np.uint8),
            "kept_pos": np.zeros(max(n_kept, 1), np.int32),
            "n_kept": 0,
            "flip": False,
            "y0": 0.0,
            "y1": 0.0,
            "vmin": np.nan,
            "vmax": np.nan,
            "empty": True,
        }
    first, last = float(energy[kept_pos[0]]), float(energy[kept_pos[-1]])
    flip = first > last
    y0, y1 = (last, first) if flip else (first, last)

    # The (T, E) selection masks are only consumed by cache-miss branches
    # (percentile pool build, linear-fallback bounds), so build them lazily
    # -- warmed passes never materialize them.
    def _sel() -> np.ndarray:
        rows = np.zeros(T, bool)
        rows[t_start : t_start + t_count] = True
        return rows[:, None] & e_keep[None, :]

    zmin_arg, zmax_arg = z_bounds
    if zmin_arg is None or zmax_arg is None:
        rows_key = (
            "full" if (zb_e_valid is not None and zb_full_time) else (int(t_start), int(t_count))
        )
        bounds_key = (
            id(matrix),
            rows_key,
            (zb_e_valid if zb_e_valid is not None else e_valid).tobytes(),
            zb_e_valid is None,
            float(low_pct),
            float(high_pct),
            None if zmin_arg is None else float(zmin_arg),
            None if zmax_arg is None else float(zmax_arg),
        )
        hit = _BOUNDS_CACHE.get(bounds_key)
        if hit is not None:
            vmin, vmax = hit
        else:
            if zb_e_valid is None:
                zb_sel = _sel()
            else:
                if zb_full_time:
                    zb_rows = np.ones(T, bool)
                else:
                    zb_rows = np.zeros(T, bool)
                    zb_rows[t_start : t_start + t_count] = True
                zb_sel = zb_rows[:, None] & ((~col_all_nan) & zb_e_valid)[None, :]
            pool = matrix[zb_sel & ~np.isnan(matrix)]

            # Both bounds from ONE partition pass.  Two scalar np.percentile
            # calls each re-partition a fresh copy of the pool (the top cost
            # of the whole host quantize stage); instead the four order
            # statistics are selected together and interpolated with the
            # verified float32 mirror of numpy's scalar-q arithmetic
            # (ops/exact_percentile.percentile_ranks/numpy_lerp_percentile:
            # scalar-q np.percentile interpolates float32 pools entirely in
            # float32, so this stays bit-exact with the reference -- pinned
            # by tests/test_reference_parity.py and the golden figures).
            wanted = ([("lo", low_pct)] if zmin_arg is None else []) + (
                [("hi", high_pct)] if zmax_arg is None else []
            )
            values = {"lo": np.nan, "hi": np.nan}
            if pool.size:
                ranks = {which: percentile_ranks(pool.size, q) for which, q in wanted}
                order = sorted({k for r in ranks.values() for k in r[:2]})
                part = np.partition(pool, order)
                for which, (k_lo, k_hi, gamma) in ranks.items():
                    values[which] = numpy_lerp_percentile(part[k_lo], part[k_hi], gamma)
            vmin = float(zmin_arg) if zmin_arg is not None else values["lo"]
            vmax = float(zmax_arg) if zmax_arg is not None else values["hi"]
            _BOUNDS_CACHE.insert(bounds_key, (vmin, vmax), (matrix,))
    else:
        vmin, vmax = float(zmin_arg), float(zmax_arg)

    # min is order-independent, so the row-sliced where-reduction is
    # bit-identical to the reference's ``matrix[fp].min()`` gather without
    # materializing the full mask; posfinite excludes +inf, so an inf
    # result can only mean "no entries".  Pure in (matrix, window, e_keep)
    # -> resident across the repeat renders of a batch.
    sv_key = ("svmin", id(matrix), int(t_start), int(t_count), e_keep.tobytes())
    safe_vmin = _MASK_CACHE.get(sv_key)
    if safe_vmin is None:
        row = slice(t_start, t_start + t_count)
        safe_vmin = float(
            np.min(
                matrix[row],
                initial=np.float32(np.inf),
                where=posfinite[row] & e_keep[None, :],
            )
        )
        if not np.isfinite(safe_vmin):
            safe_vmin = 1e-10
        _MASK_CACHE.insert(sv_key, safe_vmin, (matrix,))

    if z_scale == "log":
        vmin = max(vmin, safe_vmin, 1e-10)
        if vmin > vmax:
            # Matches the reference, where LogNorm raises at draw time when
            # the safe-positive floor exceeds an explicit vmax (batch
            # drivers record the orbit as a plotting error); rendering on
            # would silently invert the color ramp.
            raise ValueError("minvalue must be less than or equal to maxvalue")
        idx = _quantized_idx(matrix, posfinite, "log", vmin, vmax)
    else:
        if not (np.isfinite(vmin) and np.isfinite(vmax) and vmax > vmin):
            # Rare fallback: the substitutions use the ORIGINAL (possibly
            # non-finite) bounds, then the bounds are recomputed from the
            # substituted values -- keep the reference's exact sequence
            # inline rather than caching this one-off mapping.
            work = np.where(np.isnan(matrix), np.float32(vmin), matrix)
            work = np.where(np.isneginf(work), np.float32(vmin), work)
            work = np.where(np.isposinf(work), np.float32(vmax), work)
            sel = _sel()
            vmin = float(work[sel].min()) if sel.any() else 0.0
            vmax = float(work[sel].max()) if sel.any() else 1.0
            span = np.float32(vmax - vmin)
            norm = (work - np.float32(vmin)) / (span if span != 0 else np.float32(1.0))
            scaled = np.floor(norm * np.float32(256.0))
            # NaN bounds survive the substitutions (NaN -> vmin keeps NaN
            # when vmin itself is NaN), leaving NaN in ``scaled``; map such
            # cells to LUT[0] explicitly -- the NaN->uint8 cast this used to
            # rely on is platform-defined (0 on x86/ARM, but not guaranteed).
            idx = np.where(np.isnan(scaled), np.float32(0.0), np.clip(scaled, 0, 255)).astype(
                np.uint8
            )
        else:
            idx = _quantized_idx(matrix, posfinite, "linear", vmin, vmax)
    return {
        "idx": idx,
        "kept_pos": kept_pos,
        "n_kept": n_kept,
        "flip": bool(flip),
        "y0": y0,
        "y1": y1,
        "vmin": float(vmin),
        "vmax": float(vmax),
        "empty": False,
    }
