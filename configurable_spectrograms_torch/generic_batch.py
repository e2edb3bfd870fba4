"""Generic (data-agnostic) batch spectrogram plotting.

Parity with reference generic_batch.py:15-129: each item renders through
exactly one ``generic_plot_spectrogram_set`` call inside a
:func:`run_batch` worker and saves ``output_dir/<item>/generic.png`` at
150 DPI, so the batch path and the single-output function produce
identical files for identical inputs.  Workers run in threads (host I/O +
PNG encode overlap around the one GPU) instead of the reference's process
pool.
"""

from __future__ import annotations

import functools
import os
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from configurable_spectrograms_torch.batch_runner import run_batch
from configurable_spectrograms_torch.constants import GENERIC_SAVE_DPI, PLOTTING_PROGRESS_JSON_PATH
from configurable_spectrograms_torch.render.backend import recommended_workers
from configurable_spectrograms_torch.render.plotting import (
    close_all_axes_and_clear,
    generic_plot_spectrogram_set,
)
from configurable_spectrograms_torch.utils.logging import log_error


def generic_batch_plot(
    items,
    output_dir: str,
    build_datasets_fn: Callable[[Any], list[dict]],
    zoom_center_fn: Callable[[Any], float | None] | None = None,
    zoom_window_seconds: float | None = None,
    vertical_lines_fn: Callable[[Any], list[float] | None] | None = None,
    y_scale: str = "linear",
    z_scale: str = "linear",
    colormap: str = "viridis",
    cusp_marker_style: str = "both",
    cusp_marker_kwargs: dict | None = None,
    max_workers: int = 2,
    progress_json_path: str = PLOTTING_PROGRESS_JSON_PATH,
    ignore_progress_json: bool = False,
    flush_batch_size: int = 10,
    log_flush_batch_size: int | None = None,
    install_signal_handlers: bool = True,
) -> list[tuple[Any, str]]:
    """Render a ``generic_plot_spectrogram_set`` figure per item, in parallel.

    Statuses are ``ok``/``no_data``/``error``; progress persists to
    *progress_json_path* with the generic schema so interrupted runs
    resume.  ``build_datasets_fn`` maps an item to its dataset dicts;
    ``zoom_center_fn``/``vertical_lines_fn`` optionally derive the zoom
    center and cusp marks per item (reference generic_batch.py:15-129).
    """
    os.makedirs(output_dir, exist_ok=True)

    def render_item(item):
        try:
            datasets = build_datasets_fn(item)
            if not datasets:
                return (item, "no_data")
            figure, _ = generic_plot_spectrogram_set(
                datasets,
                zoom_center=zoom_center_fn(item) if zoom_center_fn else None,
                zoom_window_seconds=zoom_window_seconds,
                vertical_lines=vertical_lines_fn(item) if vertical_lines_fn else None,
                y_scale=y_scale,
                z_scale=z_scale,
                colormap=colormap,
                cusp_marker_style=cusp_marker_style,
                cusp_marker_kwargs=cusp_marker_kwargs,
                show=False,
            )
            if figure is not None:
                item_dir = os.path.join(output_dir, str(item))
                os.makedirs(item_dir, exist_ok=True)
                figure.savefig(os.path.join(item_dir, "generic.png"), dpi=GENERIC_SAVE_DPI)
                close_all_axes_and_clear(figure)
            return (item, "ok")
        except Exception as exc:
            log_error(f"[GENERIC-FAIL] Item {item}: {exc}")
            return (item, "error")

    return run_batch(
        items,
        render_item,
        functools.partial(ThreadPoolExecutor, max_workers=recommended_workers(max_workers)),
        progress_json_path=progress_json_path,
        ignore_progress_json=ignore_progress_json,
        flush_batch_size=flush_batch_size,
        log_flush_batch_size=log_flush_batch_size,
        install_signal_handlers=install_signal_handlers,
    )
