"""FAST ESA figure builders: pitch-angle grids and instrument grids.

Behavioral parity with reference fast/plotting.py:34-328, restructured for
the device pipeline: rather than collapsing each pitch-angle category on
the host to precompute percentile color bounds, the category masks and a
bounds-energy-range ride along in the panel descriptions and the device
computes the collapse *and* the bounds inside the same batched dispatch
that rasterizes the figure.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from configurable_spectrograms_torch.data.cdf_utils import (
    get_cdf_file_type,
    get_timestamps_for_orbit,
    load_fast_cdf_dataset,
)
from configurable_spectrograms_torch.fast.constants import (
    DEFAULT_INSTRUMENT_ORDER,
    DEFAULT_PITCH_ANGLE_CATEGORIES,
)
from configurable_spectrograms_torch.render.plotting import generic_plot_multirow_optional_zoom
from configurable_spectrograms_torch.utils.logging import log_exception

#: Stable row order for the four standard categories, independent of the
#: caller's dict iteration order (reference fast/plotting.py:26-31).
_PITCH_ANGLE_ROW_KEYS = (
    "all\n(0, 360)",
    "downgoing\n(0, 30), (330, 360)",
    "upgoing\n(150, 210)",
    "perpendicular\n(40, 140), (210, 330)",
)


def _orbit_marks(filtered_orbits_df, orbit_number, cdf_path, times) -> list[float] | None:
    """Cusp boundary timestamps for one file, logging when absent."""
    if filtered_orbits_df is None or orbit_number is None:
        return None
    marks = get_timestamps_for_orbit(filtered_orbits_df, orbit_number, get_cdf_file_type(cdf_path), times)
    if not marks:
        log_exception(
            f"No vertical lines found for orbit {orbit_number} in {cdf_path}. Skipping.",
            level="message",
        )
    return marks


def _row(
    times: np.ndarray,
    energy: np.ndarray,
    cube: np.ndarray,
    label: str,
    y_range: tuple[float, float],
    z_min: float | None,
    z_max: float | None,
    pitch_mask: np.ndarray | None = None,
    vmin=None,
    vmax=None,
) -> dict[str, Any]:
    """One multirow dataset dict with the FAST bound conventions attached."""
    row: dict[str, Any] = {
        "x": times,
        "y": energy,
        "data": cube,
        "label": label,
        "y_label": "Energy (eV)",
        "z_label": "Counts",
        # Device-side percentile bounds pool the y-restricted full-time
        # matrix (reference fast/plotting.py:118-134).
        "bounds_energy_range": (float(y_range[0]), float(y_range[1])),
        "y_min": y_range[0],
        "y_max": y_range[1],
        "vmin": vmin,
        "vmax": vmax,
    }
    if pitch_mask is not None:
        row["pitch_angle_mask"] = pitch_mask
    if z_min is not None:
        row["z_min"] = z_min
    if z_max is not None:
        row["z_max"] = z_max
    return row


def _render_grid(datasets, vertical_lines, title, **kw) -> tuple[Any, Any]:
    return generic_plot_multirow_optional_zoom(
        datasets,
        vertical_lines=vertical_lines,
        title=title,
        row_label_pad=50,
        row_label_rotation=90,
        **kw,
    )


def FAST_plot_pitch_angle_grid(
    cdf_file_path: str,
    filtered_orbits_df=None,
    orbit_number: int | None = None,
    zoom_duration_minutes: float = 6.25,
    scale_function_y: str = "linear",
    scale_function_z: str = "linear",
    pitch_angle_categories: dict[str, list[tuple[float, float]]] | None = None,
    show: bool = True,
    colormap: str = "viridis",
    y_min: float | None = None,
    y_max: float | None = None,
    z_min: float | None = None,
    z_max: float | None = None,
    cusp_marker_style: str = "both",
    cusp_marker_kwargs: dict | None = None,
) -> tuple[Any, Any]:
    """One instrument file -> a grid with one row per pitch-angle category.

    Rows appear in the reference's stable order with an optional zoom
    column when orbit boundary timestamps exist; color bounds per row are
    1st/99th percentiles of the category's y-filtered full-time matrix
    unless ``z_min``/``z_max`` override them
    (reference fast/plotting.py:34-174).  Returns ``(fig, canvas)`` or
    ``(None, None)`` when no row survives.
    """
    categories = pitch_angle_categories if pitch_angle_categories is not None else DEFAULT_PITCH_ANGLE_CATEGORIES
    ds = load_fast_cdf_dataset(cdf_file_path)
    times, cube, energy, pitch = ds["times"], ds["data"], ds["energy"], ds["pitch_angle"]
    marks = _orbit_marks(filtered_orbits_df, orbit_number, cdf_file_path, times)

    y_range = (0 if y_min is None else y_min, 4000 if y_max is None else y_max)
    any_energy_kept = bool(np.any((energy >= y_range[0]) & (energy <= y_range[1])))

    datasets = []
    if any_energy_kept:
        for key in _PITCH_ANGLE_ROW_KEYS:
            ranges = categories.get(key)
            if ranges is None:
                continue
            mask = np.zeros(pitch.shape, dtype=bool)
            for lo, hi in ranges:
                mask |= (pitch >= lo) & (pitch <= hi)
            datasets.append(
                _row(times, energy, cube, key.title(), y_range, z_min, z_max, pitch_mask=mask)
            )

    if not datasets:
        log_exception(f"[WARNING] No pitch angle datasets to plot for {cdf_file_path}.", level="message")
        return None, None

    inst = get_cdf_file_type(cdf_file_path)
    return _render_grid(
        datasets,
        marks,
        f"Orbit {orbit_number} - Pitch Angle {inst} ESA Spectrograms",
        zoom_duration_minutes=zoom_duration_minutes,
        y_scale=scale_function_y,
        z_scale=scale_function_z,
        colormap=colormap,
        show=show,
        y_min=y_min,
        y_max=y_max,
        z_min=z_min,
        z_max=z_max,
        cusp_marker_style=cusp_marker_style,
        cusp_marker_kwargs=cusp_marker_kwargs,
    )


def FAST_plot_instrument_grid(
    cdf_file_paths: dict[str, str],
    filtered_orbits_df=None,
    orbit_number: int | None = None,
    zoom_duration_minutes: float = 6.25,
    scale_function_y: str = "linear",
    scale_function_z: str = "linear",
    instrument_order: tuple[str, ...] = DEFAULT_INSTRUMENT_ORDER,
    show: bool = True,
    colormap: str = "viridis",
    y_min: float | None = None,
    y_max: float | None = None,
    z_min: float | None = None,
    z_max: float | None = None,
    global_extrema: dict[str, int | float] | None = None,
    cusp_marker_style: str = "both",
    cusp_marker_kwargs: dict | None = None,
) -> tuple[Any, Any]:
    """One orbit's instrument files -> a grid with one row per instrument.

    Vertical lines come from the first instrument whose file loads;
    ``global_extrema`` keys (``{inst}_{y}_{z}_{y|z}_{min|max}``) override
    the direct bound arguments per instrument; broken/missing files are
    logged and skipped (reference fast/plotting.py:177-328).
    """
    datasets = []
    marks = None
    for inst in instrument_order:
        path = cdf_file_paths.get(inst)
        if not path:
            continue
        try:
            ds = load_fast_cdf_dataset(path)
        except Exception as exc:
            log_exception(f"Failed to load CDF for {inst} at {path}. Skipping.", exc, level="error")
            continue
        times, cube, energy = ds["times"], ds["data"], ds["energy"]
        if marks is None:
            marks = _orbit_marks(filtered_orbits_df, orbit_number, path, times)

        if isinstance(global_extrema, dict):
            prefix = f"{inst}_{scale_function_y}_{scale_function_z}"
            y_range = (
                global_extrema.get(f"{prefix}_y_min", 0 if y_min is None else y_min),
                global_extrema.get(f"{prefix}_y_max", 4000 if y_max is None else y_max),
            )
            row_z = (global_extrema.get(f"{prefix}_z_min"), global_extrema.get(f"{prefix}_z_max"))
        else:
            y_range = (0 if y_min is None else y_min, 4000 if y_max is None else y_max)
            row_z = (None, None)

        if not np.any((energy >= y_range[0]) & (energy <= y_range[1])):
            continue
        datasets.append(
            _row(times, energy, cube, inst.upper(), y_range, z_min, z_max, vmin=row_z[0], vmax=row_z[1])
        )

    if not datasets:
        return None, None

    return _render_grid(
        datasets,
        marks,
        f"Orbit {orbit_number} -  ESA Spectrograms",
        zoom_duration_minutes=zoom_duration_minutes,
        y_scale=scale_function_y,
        z_scale=scale_function_z,
        colormap=colormap,
        show=show,
        y_min=y_min,
        y_max=y_max,
        z_min=z_min,
        z_max=z_max,
        cusp_marker_style=cusp_marker_style,
        cusp_marker_kwargs=cusp_marker_kwargs,
    )
