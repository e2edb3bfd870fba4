"""Eager-torch spectrogram rasterization math (port of ``ops/spectrogram.py``).

The same data path as the JAX module, function for function: the masked
pitch collapse, the all-NaN-column and energy-range masks, percentile
colour bounds from a sort-free bitwise selection, log/linear
normalisation with safe floors, matplotlib's colormap index rule, and the
imshow-style extent resampling.  Where JAX vmaps, every function here takes
a leading lane dimension written out: ``matrix`` is (L, T, E), per-lane
scalars are (L,) tensors.  ``jit`` static arguments became plain Python
branches.  Eager torch rounds every operation on its own, so the JAX
module's ``_block_fma`` guard has no counterpart here.

Three traps shape the code.  ``uint32`` tensors lack ``>>``, ``~``, ``<``
and ``where`` on the CPU, so the order keys are int64.  ``torch.quantile``
does not interpolate the way numpy does, so the percentile lerp is
numpy's own, branch for branch.  And on CUDA, dividing a tensor by a
Python scalar multiplies by the scalar's reciprocal (not the IEEE
quotient), so every divisor here is a tensor on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from configurable_spectrograms_torch.ops.kernels import collapse_lanes

_BIG = 3.0e38
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class RenderSpec:
    """Static configuration for one panel rasterization (as in the JAX module)."""

    height: int
    width: int
    y_scale: str = "linear"  # 'linear' | 'log'
    z_scale: str = "linear"  # 'linear' | 'log'
    low_percentile: float = 1.0
    high_percentile: float = 99.0
    bg_rgba: tuple[int, int, int, int] = (255, 255, 255, 255)


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar tensor on *device*, made by a fill: a copy from the host would synchronise the stream."""
    return torch.full((), x, dtype=torch.float32, device=device)


def collapse_cube(cube: torch.Tensor, pitch_mask: torch.Tensor, t_valid: int) -> torch.Tensor:
    """Collapse one (T, A, E) cube to (T, E) with masked ``nansum`` semantics.

    NaN counts as zero, +/-inf propagate, rows at or beyond ``t_valid`` are
    NaN.  Runs on the collapse kernel (its plain version on the CPU).
    """
    dev = cube.device
    out = collapse_lanes(
        cube.float().contiguous().unsqueeze(0),
        torch.zeros((1,), dtype=torch.int32, device=dev),
        pitch_mask.to(device=dev, dtype=torch.bool).reshape(1, -1).contiguous(),
        torch.tensor([int(t_valid)], dtype=torch.int32, device=dev),
    )
    return out[0]


def _sortable_u32(flat: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys in ``[0, 2**32)`` whose order is IEEE total order.

    The unsigned-32 key of the JAX module (non-negative floats set the sign
    bit, negative floats flip every bit), held in int64; entries with
    ``ok`` False map to 0xFFFFFFFF, above every valid key.
    """
    bits = flat.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    neg = (bits >> 31) == 1
    keys = torch.where(neg, (~bits) & _U32, bits | 0x80000000)
    return torch.where(ok, keys, torch.full_like(keys, _U32))


def select_order_stats(keys: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Values at ``ranks`` of the ascending-sorted ``keys`` -- no sort.

    ``keys`` (L, N) int64 from :func:`_sortable_u32`, ``ranks`` (L, R)
    0-indexed order statistics.  Binary search on the key bits, MSB first:
    bit ``b`` is set exactly when at most ``rank`` keys are below
    ``prefix | 1 << b``.  Returns (L, R) float32.
    """
    ranks = ranks.to(torch.int64)
    prefix = torch.zeros(ranks.shape, dtype=torch.int64, device=keys.device)
    for i in range(32):
        cand = prefix | (1 << (31 - i))
        below = (keys.unsqueeze(-1) < cand.unsqueeze(-2)).sum(dim=-2)
        prefix = torch.where(below <= ranks, cand, prefix)
    neg = (prefix >> 31) == 0
    bits = torch.where(neg, (~prefix) & _U32, prefix & 0x7FFFFFFF)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _percentile_ranks(q: float, n: torch.Tensor):
    """numpy's virtual index for percentile ``q`` of ``n`` values (float32).

    ``q / 100`` is rounded once in float32 on the host: on CUDA, torch
    divides a tensor by a Python scalar as a multiply by its reciprocal,
    which is not the IEEE quotient numpy and XLA compute.
    """
    q100 = np.float32(q) / np.float32(100.0)
    pos = _f32(q100, n.device) * torch.clamp_min(n - 1, 0).to(torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float32)
    return lo, hi, frac


def _numpy_lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """numpy's ``_lerp``, branch for branch: ``a + d*t`` below 0.5, ``b - d*(1-t)`` above."""
    diff = b - a
    return torch.where(t >= 0.5, b - diff * (1.0 - t), a + diff * t)


def _lerp_or_nan(s_lo, s_hi, frac, n):
    v = _numpy_lerp(s_lo, s_hi, frac)
    # frac == 0 short-circuits so +/-inf endpoints don't produce inf-inf NaNs.
    v = torch.where(frac == 0, s_lo, v)
    return torch.where(n > 0, v, torch.full_like(v, float("nan")))


def masked_nanpercentile(values: torch.Tensor, valid: torch.Tensor, q: float) -> torch.Tensor:
    """``np.nanpercentile`` (linear interpolation) over ``values[valid]`` per lane.

    ``values``/``valid`` are (L, ...); returns (L,) float32, NaN where a
    lane has nothing valid.
    """
    L = values.shape[0]
    flat = values.reshape(L, -1).float()
    ok = valid.reshape(L, -1) & ~torch.isnan(flat)
    n = ok.sum(dim=1)
    lo, hi, frac = _percentile_ranks(q, n)
    s = select_order_stats(_sortable_u32(flat, ok), torch.stack([lo, hi], dim=1))
    return _lerp_or_nan(s[:, 0], s[:, 1], frac, n)


def _kept_energy_order(col_all_nan: torch.Tensor, e_valid: torch.Tensor, energy: torch.Tensor):
    """Which energy columns survive masking, and in what draw order (per lane).

    Returns ``(kept_pos, n_kept, flip, y0, y1)`` as in the JAX module:
    ``kept_pos[l, j]`` is the original column of lane l's j-th kept bin,
    ``flip`` mirrors the reference's descending-energy reversal and
    ``y0``/``y1`` are the drawn extent endpoints.
    """
    e_keep = (~col_all_nan) & e_valid
    L, E = e_keep.shape
    iota = torch.arange(E, device=e_keep.device).expand(L, E)
    kept_pos = torch.argsort(torch.where(e_keep, iota, E + 1), dim=1, stable=True)
    n_kept = e_keep.sum(dim=1)
    first = torch.gather(energy, 1, kept_pos[:, :1])[:, 0]
    last_pos = torch.gather(kept_pos, 1, torch.clamp_min(n_kept - 1, 0).unsqueeze(1))
    last = torch.gather(energy, 1, last_pos)[:, 0]
    flip = first > last
    y0 = torch.where(flip, last, first)
    y1 = torch.where(flip, first, last)
    return kept_pos, n_kept, flip, y0, y1


def _analyze_matrix(matrix, energy, e_valid, t_valid, t_start, t_count, z_bounds, spec: RenderSpec,
                    zb_e_valid=None, zb_full_time=None, skip_percentile: bool = False) -> dict:
    """Masking, colour bounds, normalisation and colormap index, per lane.

    ``matrix`` (L, T, E) float32 with rows at/after ``t_valid`` NaN;
    ``energy``/``e_valid``/``zb_e_valid`` (L, E); ``t_valid``/``t_start``/
    ``t_count`` (L,) int; ``z_bounds`` (L, 2) float32 with NaN meaning
    "percentile bound"; ``zb_full_time`` (L,) bool.  Returns ``idx``
    (L, T, E) uint8 plus per-lane ``kept_pos``, ``n_kept``, ``flip``,
    ``y0``, ``y1``, ``vmin``, ``vmax``, ``empty``.
    """
    L, T, E = matrix.shape
    dev = matrix.device
    matrix = matrix.float()
    energy = energy.float()
    rows = torch.arange(T, device=dev).view(1, T)
    in_file = rows < t_valid.view(L, 1)
    # All-NaN-column mask over the full (unzoomed) file rows.
    col_all_nan = (torch.isnan(matrix) | ~in_file.unsqueeze(-1)).all(dim=1)
    kept_pos, n_kept, flip, y0, y1 = _kept_energy_order(col_all_nan, e_valid, energy)

    in_window = in_file & (rows >= t_start.view(L, 1)) & (rows < (t_start + t_count).view(L, 1))
    e_keep = (~col_all_nan) & e_valid
    sel = in_window.unsqueeze(-1) & e_keep.unsqueeze(1)
    empty = (n_kept == 0) | (t_count <= 0)

    zmin_arg, zmax_arg = z_bounds[:, 0].float(), z_bounds[:, 1].float()
    if skip_percentile:
        vmin, vmax = zmin_arg, zmax_arg
    else:
        if zb_e_valid is None:
            zb_sel = sel
        else:
            full = torch.zeros((L,), dtype=torch.bool, device=dev) if zb_full_time is None else zb_full_time
            zb_rows = torch.where(full.view(L, 1), in_file, in_window)
            zb_sel = zb_rows.unsqueeze(-1) & ((~col_all_nan) & zb_e_valid).unsqueeze(1)
        flat = matrix.reshape(L, -1)
        ok = zb_sel.reshape(L, -1) & ~torch.isnan(flat)
        n_ok = ok.sum(dim=1)
        lo1, hi1, frac1 = _percentile_ranks(spec.low_percentile, n_ok)
        lo2, hi2, frac2 = _percentile_ranks(spec.high_percentile, n_ok)
        s = select_order_stats(_sortable_u32(flat, ok), torch.stack([lo1, hi1, lo2, hi2], dim=1))
        vmin = torch.where(torch.isnan(zmin_arg), _lerp_or_nan(s[:, 0], s[:, 1], frac1, n_ok), zmin_arg)
        vmax = torch.where(torch.isnan(zmax_arg), _lerp_or_nan(s[:, 2], s[:, 3], frac2, n_ok), zmax_arg)

    big = _f32(_BIG, dev)
    finite_positive = torch.isfinite(matrix) & (matrix > 0) & sel
    safe_vmin = torch.where(
        finite_positive.any(dim=(1, 2)),
        torch.where(finite_positive, matrix, big).amin(dim=(1, 2)),
        _f32(1e-10, dev),
    )
    zero, one = _f32(0.0, dev), _f32(1.0, dev)
    if spec.z_scale == "log":
        vmin = torch.maximum(torch.maximum(vmin, safe_vmin), _f32(1e-10, dev))
        work = torch.where(~torch.isfinite(matrix) | (matrix <= 0), vmin.view(L, 1, 1), matrix)
        log_vmin = torch.log10(vmin)
        log_span = torch.log10(vmax) - log_vmin
        ramp = (torch.log10(torch.clamp_min(work, 1e-37)) - log_vmin.view(L, 1, 1)) / torch.where(
            log_span == 0, one, log_span
        ).view(L, 1, 1)
        # matplotlib's Normalize fills 0 for EVERY cell when vmin == vmax;
        # test the raw bounds, not the logs.
        norm = torch.where((vmin == vmax).view(L, 1, 1), zero, ramp)
    else:
        work = torch.where(torch.isnan(matrix), vmin.view(L, 1, 1), matrix)
        work = torch.where(torch.isneginf(work), vmin.view(L, 1, 1), work)
        work = torch.where(torch.isposinf(work), vmax.view(L, 1, 1), work)
        # Degenerate/invalid bounds fall back to the substituted matrix's
        # own min/max (reference plotting.py:313-315).
        bad = ~(torch.isfinite(vmin) & torch.isfinite(vmax) & (vmax > vmin))
        fb_min = torch.where(sel, work, big).amin(dim=(1, 2))
        fb_max = torch.where(sel, work, -big).amax(dim=(1, 2))
        vmin = torch.where(bad & ~empty, fb_min, vmin)
        vmax = torch.where(bad & ~empty, fb_max, vmax)
        span = vmax - vmin
        ramp = (work - vmin.view(L, 1, 1)) / torch.where(span == 0, one, span).view(L, 1, 1)
        norm = torch.where((vmin == vmax).view(L, 1, 1), zero, ramp)
    # matplotlib Colormap.__call__ index rule: int(norm * 256) clipped to
    # [0, 255]; NaN cells pin to LUT[0].
    norm = torch.where(torch.isnan(norm), zero, norm)
    idx = torch.clamp(torch.floor(norm * 256.0), 0.0, 255.0).to(torch.uint8)
    return {
        "idx": idx,
        "kept_pos": kept_pos.to(torch.int32),
        "n_kept": n_kept.to(torch.int32),
        "flip": flip,
        "y0": y0,
        "y1": y1,
        "vmin": vmin.float(),
        "vmax": vmax.float(),
        "empty": empty,
    }


def quantize_matrix(matrix, energy, e_valid, t_valid, t_start, t_count, z_bounds, spec: RenderSpec,
                    zb_e_valid=None, zb_full_time=None, skip_percentile: bool = False) -> dict:
    """The light-readback production analysis (see :func:`_analyze_matrix`).

    ``skip_percentile=True`` takes both bounds as given (the given-extrema
    half of a batch), so no selection runs.
    """
    return _analyze_matrix(matrix, energy, e_valid, t_valid, t_start, t_count, z_bounds, spec,
                           zb_e_valid, zb_full_time, skip_percentile)


def render_matrix(matrix, energy, e_valid, t_valid, t_start, t_count, x_map, z_bounds, lut,
                  spec: RenderSpec, zb_e_valid=None, zb_full_time=None, out_h=None, out_w=None) -> dict:
    """Rasterize collapsed (L, T, E) matrices to (L, H, W, 4) RGBA tiles.

    ``x_map`` (L, 2) float32 maps output pixel columns to fractional
    matrix rows (``col_f = x_map[0] * px + x_map[1]``); ``lut`` (L, 256, 4)
    uint8.  Rows are in PNG order (row 0 = top), as the JAX module returns
    them.  Scalars as in :func:`_analyze_matrix`.  ``out_h`` / ``out_w``
    (L,) int, where given, are each lane's real size inside the
    ``spec.height`` x ``spec.width`` tile, as in the JAX module: pixels at
    or beyond them render as background, and the valid region lands at
    rows ``[H - out_h, H)`` of the returned tile.
    """
    H, W = spec.height, spec.width
    L, T, E = matrix.shape
    dev = matrix.device
    a = _analyze_matrix(matrix, energy, e_valid, t_valid, t_start, t_count, z_bounds, spec,
                        zb_e_valid, zb_full_time)
    idx = a["idx"].to(torch.int64)
    kept_pos, n_kept, flip = a["kept_pos"].to(torch.int64), a["n_kept"].to(torch.int64), a["flip"]
    y0, y1 = a["y0"], a["y1"]

    # imshow extent resampling (pixel replication).
    px = torch.arange(W, device=dev, dtype=torch.float32).view(1, W)
    x_map = x_map.float()
    col_f = x_map[:, :1] * px + x_map[:, 1:]
    x_ok = (col_f >= 0.0) & (col_f <= t_count.view(L, 1).to(torch.float32))
    if out_w is not None:
        x_ok = x_ok & (px < out_w.view(L, 1).to(torch.float32))
    col = torch.minimum(torch.clamp_min(col_f.to(torch.int64), 0), torch.clamp_min(t_count.view(L, 1).long() - 1, 0))
    t_idx = torch.clamp(t_start.view(L, 1).long() + col, 0, T - 1)  # (L, W)

    # Divide by a device tensor: a Python-scalar divisor becomes a
    # reciprocal multiply on CUDA (see _percentile_ranks).
    py_r = torch.arange(H, device=dev, dtype=torch.float32).view(1, H)
    py = (py_r + 0.5) / (_f32(float(H), dev) if out_h is None else out_h.view(L, 1).to(torch.float32))
    nk = torch.clamp_min(n_kept, 1).to(torch.float32).view(L, 1)
    if spec.y_scale == "log":
        ly0 = torch.log10(torch.clamp_min(y0, 1e-37)).view(L, 1)
        ly1 = torch.log10(torch.clamp_min(y1, 1e-37)).view(L, 1)
        y_data = torch.pow(_f32(10.0, dev), ly0 + py * (ly1 - ly0))
        denom = torch.where(y1 == y0, _f32(1.0, dev), y1 - y0).view(L, 1)
        row_f = (y_data - y0.view(L, 1)) / denom * nk
    else:
        row_f = py * nk
    row = torch.minimum(torch.clamp_min(row_f.to(torch.int64), 0), torch.clamp_min(n_kept.view(L, 1) - 1, 0))
    row_eff = torch.where(flip.view(L, 1), n_kept.view(L, 1) - 1 - row, row)
    e_idx = torch.gather(kept_pos, 1, torch.clamp(row_eff, 0, E - 1))  # (L, H)

    lanes = torch.arange(L, device=dev).view(L, 1, 1)
    tile_idx = idx[lanes, t_idx.view(L, 1, W), e_idx.view(L, H, 1)]  # (L, H, W)
    visible = x_ok.view(L, 1, W) & ~a["empty"].view(L, 1, 1)
    if out_h is not None:
        visible = visible & (py_r < out_h.view(L, 1).to(torch.float32)).view(L, H, 1)
    bg = torch.tensor(spec.bg_rgba, dtype=torch.uint8, device=dev).view(1, 1, 4).expand(L, 1, 4)
    lut_ext = torch.cat([lut.to(device=dev, dtype=torch.uint8), bg], dim=1)  # (L, 257, 4)
    final_idx = torch.where(visible, tile_idx, torch.full_like(tile_idx, 256))
    rgba = lut_ext[lanes, final_idx]  # (L, H, W, 4), origin lower
    return {
        "rgba": torch.flip(rgba, dims=[1]),
        "vmin": a["vmin"],
        "vmax": a["vmax"],
        "y0": y0,
        "y1": y1,
        "n_kept": a["n_kept"],
        "empty": a["empty"],
    }


def render_panels(matrices, energies, e_valids, t_valids, t_starts, t_counts, x_maps, z_bounds,
                  luts, spec: RenderSpec) -> dict:
    """:func:`render_matrix` over a batch of panels (the leading dimension)."""
    return render_matrix(matrices, energies, e_valids, t_valids, t_starts, t_counts, x_maps,
                         z_bounds, luts, spec)
