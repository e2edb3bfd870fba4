"""Single-output spectrogram rendering (public API parity layer).

These functions mirror the reference's ``plotting.py`` API surface --
``make_spectrogram`` (reference plotting.py:92-389),
``generic_plot_spectrogram_set`` (reference plotting.py:392-502),
``generic_plot_multirow_optional_zoom`` (reference plotting.py:505-698),
``close_all_axes_and_clear`` (reference plotting.py:51-89) -- but describe
panels into a :class:`~configurable_spectrograms_torch.render.figure.SpectroFigure`
instead of drawing with matplotlib.  All pixel math runs on device when the
figure is saved; single-plot CLIs, batch drivers, and the FAST layer all
call these same functions, so one item rendered any way produces identical
output (the reference's core invariant, reference plotting.py:3-9).

A copy of the JAX package's ``render/plotting.py`` without its host
compute gate.
"""

from __future__ import annotations

from datetime import datetime, timezone

import numpy as np

from configurable_spectrograms_torch.constants import (
    PLOT_FIGURE_HEIGHT_INCHES,
    PLOT_FIGURE_WIDTH_INCHES,
)
from configurable_spectrograms_torch.render.figure import (  # noqa: F401 - Axes re-exported: make_spectrogram returns one
    AXIS_LABEL_PT,
    Axes,
    PanelData,
    SpectroFigure,
)
from configurable_spectrograms_torch.render.tile import compute_time_window
from configurable_spectrograms_torch.utils.logging import log_message

#: Colormaps whose high end is already red, so the cusp line marker's top
#: line switches to white to stay visible (reference plotting.py:41-48).
_RED_HEAVY_COLORMAPS = {"turbo", "jet"}

#: matplotlib's modern date epoch: days since 1970-01-01 UTC.
_SECONDS_PER_DAY = 86400.0


def close_all_axes_and_clear(fig) -> None:
    """Clear a figure's panel descriptions (API parity; reference plotting.py:51-89).

    Device tiles and PIL buffers are not retained between renders, so there
    is no Agg canvas/Gcf registry to tear down; this simply drops the
    panel list so a reused figure starts clean.
    """
    try:
        fig.clear()
    except Exception as exc:
        log_message(f"[WARN] Error clearing figure: {exc}")


def make_spectrogram(
    x_axis_values,
    y_axis_values,
    data_array_3d,
    x_axis_min=None,
    x_axis_max=None,
    x_axis_is_unix=True,
    x_axis_label=None,
    center_timestamp=None,
    window_duration_seconds=None,
    y_axis_scale_function=None,
    y_axis_label=None,
    y_axis_min=0,
    y_axis_max=4000,
    z_axis_scale_function=None,
    z_axis_min=None,
    z_axis_max=None,
    z_axis_label=None,
    collapse_axis=1,
    colormap="viridis",
    axis_object=None,
    instrument_label=None,
    vertical_lines_unix=None,
    cusp_marker_style="both",
    cusp_marker_kwargs=None,
    pitch_angle_mask=None,
    bounds_energy_range=None,
):
    """Describe one spectrogram panel (API parity with reference plotting.py:92-176).

    Identical signature and filtering semantics to the reference's
    ``make_spectrogram``; the panel is queued on ``axis_object`` (or a new
    single-panel figure) and rasterized on device at save time.  The one
    extension is ``pitch_angle_mask``: a boolean mask over the collapse
    axis, letting the FAST pitch-angle grid collapse categories on device
    instead of pre-slicing the cube per category on host.

    Returns
    -------
    (Axes or None, numpy.ndarray or None)
        The axes drawn into and the plotted x values (matplotlib date
        numbers when ``x_axis_is_unix``), or ``(None, None)`` when
        filtering leaves nothing to draw.
    """
    x_axis = np.asarray(x_axis_values, dtype=np.float64)
    y_axis = np.asarray(y_axis_values, dtype=np.float32)
    data_array = np.asarray(data_array_3d)
    if data_array.ndim != 3:
        raise ValueError(f"data_array_3d must be 3D, got shape {data_array.shape}")
    if collapse_axis != 1:
        data_array = np.moveaxis(data_array, collapse_axis, 1)
    if x_axis.size > 1 and np.any(np.diff(x_axis) < 0):
        # The reference's boolean-mask filters tolerate unsorted time; the
        # contiguous-window fast path needs monotonic x, so sort rows once
        # here (stable, so duplicate timestamps keep file order).
        order = np.argsort(x_axis, kind="stable")
        x_axis = x_axis[order]
        data_array = data_array[order]

    y_lo = 0 if y_axis_min is None else float(y_axis_min)
    y_hi = 4000 if y_axis_max is None else float(y_axis_max)
    if not np.any((y_axis >= y_lo) & (y_axis <= y_hi)):
        log_message("[WARNING] All energy bins were filtered out. No data to plot.")
        return None, None

    window = compute_time_window(
        x_axis,
        center=center_timestamp,
        duration_seconds=window_duration_seconds,
        x_min=x_axis_min,
        x_max=x_axis_max,
    )
    if window is None:
        log_message("[WARNING] No data to plot after filtering. Skipping plot.")
        return None, None

    if axis_object is None:
        fig = SpectroFigure(figsize=(PLOT_FIGURE_WIDTH_INCHES, PLOT_FIGURE_HEIGHT_INCHES))
        axis_object = fig.add_subplot(1, 1, 1)

    x_selected = x_axis[window.t_start : window.t_start + window.t_count]
    x_axis_plot = x_selected / _SECONDS_PER_DAY if x_axis_is_unix else x_selected
    x_label = x_axis_label if x_axis_label is not None else ("Time (UTC)" if x_axis_is_unix else "X")

    vertical_lines: list[float] = []
    if vertical_lines_unix is not None and len(vertical_lines_unix) > 0:
        lo, hi = float(x_selected[0]), float(x_selected[-1])
        vertical_lines = [float(v) for v in vertical_lines_unix if lo <= v <= hi]

    n_angle = data_array.shape[1]
    mask = (
        np.asarray(pitch_angle_mask, dtype=bool)
        if pitch_angle_mask is not None
        else np.ones(n_angle, dtype=bool)
    )

    axis_object.panel = PanelData(
        cube=np.ascontiguousarray(data_array, dtype=np.float32),
        pitch_mask=mask,
        energy=y_axis,
        times=x_axis,
        window=window,
        y_min=y_lo,
        y_max=y_hi,
        z_min=None if z_axis_min is None else float(z_axis_min),
        z_max=None if z_axis_max is None else float(z_axis_max),
        y_scale=y_axis_scale_function or "linear",
        z_scale=z_axis_scale_function or "linear",
        colormap=colormap,
        x_is_unix=bool(x_axis_is_unix),
        z_label=z_axis_label if z_axis_label is not None else "Counts",
        vertical_lines=vertical_lines,
        cusp_marker_style=cusp_marker_style,
        cusp_marker_kwargs=dict(cusp_marker_kwargs or {}),
        line_color="white" if colormap in _RED_HEAVY_COLORMAPS else "red",
        bounds_energy_range=bounds_energy_range,
    )
    axis_object.set_xlabel(x_label)
    axis_object.set_ylabel(y_axis_label if y_axis_label is not None else "Energy (eV)")
    if instrument_label is not None:
        axis_object.set_title(instrument_label)
    return axis_object, x_axis_plot


def generic_plot_spectrogram_set(
    datasets,
    collapse_axis=1,
    zoom_center=None,
    zoom_window_seconds=None,
    vertical_lines=None,
    x_is_unix=True,
    y_scale="linear",
    z_scale="linear",
    colormap="viridis",
    figure_title=None,
    show=False,
    y_min=None,
    y_max=None,
    z_min=None,
    z_max=None,
    cusp_marker_style="both",
    cusp_marker_kwargs=None,
):
    """Vertical stack of generic spectrograms (reference plotting.py:392-502).

    Each dataset dict requires ``'x'``, ``'y'``, ``'data'`` and honors the
    same optional per-row keys (``label``/``y_label``/``z_label``/
    ``y_min``/``y_max``/``z_min``/``z_max``).  Returns ``(fig, canvas)``
    where ``canvas`` is the figure itself (no separate Agg canvas exists),
    or ``(None, None)`` for empty input.
    """
    if not datasets:
        return None, None
    fig = SpectroFigure(figsize=(10, 3 * len(datasets)))
    for row_index, dataset in enumerate(datasets):
        axis_obj = fig.add_subplot(len(datasets), 1, row_index + 1)
        dataset_y_min = dataset.get("y_min", y_min)
        dataset_y_max = dataset.get("y_max", y_max)
        dataset_z_min = dataset.get("z_min", z_min)
        dataset_z_max = dataset.get("z_max", z_max)
        inferred_y_max = (
            dataset["y"].max() if dataset_y_max is None and dataset.get("y") is not None else dataset_y_max
        )
        make_spectrogram(
            x_axis_values=dataset["x"],
            y_axis_values=dataset["y"],
            data_array_3d=dataset["data"],
            collapse_axis=collapse_axis,
            center_timestamp=zoom_center,
            window_duration_seconds=zoom_window_seconds,
            x_axis_is_unix=x_is_unix,
            y_axis_scale_function=y_scale,
            z_axis_scale_function=z_scale,
            y_axis_min=dataset_y_min if dataset_y_min is not None else 0,
            y_axis_max=inferred_y_max if inferred_y_max is not None else 4000,
            z_axis_min=dataset_z_min,
            z_axis_max=dataset_z_max,
            colormap=colormap,
            y_axis_label=dataset.get("y_label", "Energy (eV)"),
            z_axis_label=dataset.get("z_label", "Counts"),
            x_axis_label="Time (UTC)" if x_is_unix else dataset.get("x_label"),
            vertical_lines_unix=vertical_lines,
            cusp_marker_style=cusp_marker_style,
            cusp_marker_kwargs=cusp_marker_kwargs,
            axis_object=axis_obj,
        )
        if dataset.get("label"):
            axis_obj.set_title(dataset["label"])
    if figure_title:
        fig.suptitle(figure_title)
    fig.tight_layout(rect=(0, 0, 1, 0.97))
    if show:
        _show_figure(fig)
    return fig, fig


def generic_plot_multirow_optional_zoom(
    datasets,
    vertical_lines=None,
    zoom_duration_minutes=6.25,
    y_scale="linear",
    z_scale="linear",
    colormap="viridis",
    show=False,
    title=None,
    row_label_pad=50,
    row_label_rotation=90,
    y_min=None,
    y_max=None,
    z_min=None,
    z_max=None,
    cusp_marker_style="both",
    cusp_marker_kwargs=None,
):
    """Multi-row grid with an optional zoom column (reference plotting.py:505-698).

    The zoom-column decision matches the reference exactly: 1 marker ->
    center = marker / requested duration; 2 markers -> center = midpoint,
    duration = max(requested, 1.5x marker span); the column renders only if
    some dataset has non-NaN data inside the window.  Footer shows the data
    timespan plus a red marked-range line.
    """
    if not datasets:
        return None, None
    zoom_needed = False
    center_value = None
    duration = None
    if vertical_lines and len(vertical_lines) > 0:
        if len(vertical_lines) == 1:
            center_value = vertical_lines[0]
            duration = zoom_duration_minutes * 60
        else:
            center_value = 0.5 * (vertical_lines[0] + vertical_lines[1])
            min_window = abs(vertical_lines[1] - vertical_lines[0]) * 1.5
            requested_window = zoom_duration_minutes * 60
            duration = max(requested_window, min_window)
        left = center_value - duration / 2
        right = center_value + duration / 2
        for ds in datasets:
            t = np.asarray(ds["x"])
            d = np.asarray(ds["data"])
            mask_zoom = (t >= left) & (t <= right)
            if np.any(~np.isnan(d[mask_zoom])):
                zoom_needed = True
                break

    number_rows = len(datasets)
    number_columns = 2 if zoom_needed else 1
    fig = SpectroFigure(figsize=(12 * number_columns, 3 * number_rows))
    axes = np.empty((number_rows, number_columns), dtype=object)
    for i in range(number_rows):
        for j in range(number_columns):
            axes[i, j] = fig.add_subplot(number_rows, number_columns, i * number_columns + j + 1)

    for i, ds in enumerate(datasets):
        times = np.asarray(ds["x"])
        energy = ds["y"]
        data3d = ds["data"]
        vmin = ds.get("vmin")
        vmax = ds.get("vmax")
        common = dict(
            x_axis_values=times,
            y_axis_values=energy,
            data_array_3d=data3d,
            collapse_axis=1,
            x_axis_is_unix=True,
            instrument_label=None,
            y_axis_scale_function=y_scale,
            z_axis_scale_function=z_scale,
            vertical_lines_unix=vertical_lines,
            cusp_marker_style=cusp_marker_style,
            cusp_marker_kwargs=cusp_marker_kwargs,
            # The reference's multirow path deliberately does NOT forward
            # y bounds to make_spectrogram (reference plotting.py:618-656);
            # per-row y_min/y_max only shaped the precomputed vmin/vmax.
            z_axis_min=vmin if z_min is None else z_min,
            z_axis_max=vmax if z_max is None else z_max,
            colormap=colormap,
            pitch_angle_mask=ds.get("pitch_angle_mask"),
            bounds_energy_range=ds.get("bounds_energy_range"),
        )
        make_spectrogram(
            x_axis_min=times[0],
            x_axis_max=times[-1],
            axis_object=axes[i, 0],
            **common,
        )
        if number_columns == 2:
            make_spectrogram(
                center_timestamp=center_value,
                window_duration_seconds=duration,
                axis_object=axes[i, 1],
                **common,
            )

    for i, ds in enumerate(datasets):
        axes[i, 0].set_ylabel(
            ds.get("label", ""),
            fontsize=AXIS_LABEL_PT,
            rotation=row_label_rotation,
        )
    axes[0, 0].set_title("Full", fontsize=AXIS_LABEL_PT)
    if number_columns == 2:
        axes[0, 1].set_title("Zoomed", fontsize=AXIS_LABEL_PT)
    if title:
        fig.suptitle(title, fontsize=AXIS_LABEL_PT + 2)

    base_times = np.asarray(datasets[0]["x"])
    t0 = datetime.fromtimestamp(float(base_times[0]), tz=timezone.utc)
    t1 = datetime.fromtimestamp(float(base_times[-1]), tz=timezone.utc)
    data_timespan_str = (
        f"Data timespan: {t0.strftime('%Y-%m-%d %H:%M:%S')} to {t1.strftime('%Y-%m-%d %H:%M:%S')} UTC"
    )
    fig.subplots_adjust(bottom=0.18)
    fig.text(0.5, 0.01, data_timespan_str, ha="center", va="bottom", fontsize=13)
    if vertical_lines and len(vertical_lines) > 0:
        v0 = datetime.fromtimestamp(min(vertical_lines), tz=timezone.utc)
        v1 = datetime.fromtimestamp(max(vertical_lines), tz=timezone.utc)
        marked_str = (
            f"Marked range: {v0.strftime('%Y-%m-%d %H:%M:%S')} to {v1.strftime('%Y-%m-%d %H:%M:%S')} UTC"
        )
        fig.text(0.5, 0.045, marked_str, ha="center", va="bottom", fontsize=13, color="red")
    if show:
        _show_figure(fig)
    return fig, fig


def _show_figure(fig) -> None:
    """Best-effort interactive display (the reference's ``show=True``).

    Renders and hands the image to the system viewer; silently a no-op on
    headless machines (reference plotting.py:498-501,694-697 used
    ``plt.show``, equally dependent on a display).
    """
    try:
        fig.render().show()
    except Exception as exc:
        log_message(f"[WARN] show=True but no display available: {exc}")
