"""Typed configuration objects over the keyword-argument driver surfaces (port of ``utils/config.py``).

The reference configures everything through module constants, argparse
flags, and very wide keyword surfaces (22 parameters on the batch driver).
Those keyword surfaces are kept verbatim for parity; these dataclasses are
the typed front door: construct once, tweak with ``replace``, run with
``.run()``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from configurable_spectrograms_torch.constants import DEFAULT_ZOOM_WINDOW_MINUTES
from configurable_spectrograms_torch.fast.constants import (
    DEFAULT_INSTRUMENT_ORDER,
    FAST_CDF_DATA_FOLDER_PATH,
    FAST_OUTPUT_BASE,
    FAST_PLOTTING_PROGRESS_JSON,
)


@dataclass(frozen=True)
class ScaleCombo:
    """One (y_scale, z_scale, colormap) rendering combination."""

    y_scale: str = "linear"
    z_scale: str = "log"
    colormap: str = "cividis"


#: The reference flagship's four combos with their matched colormaps
#: (reference batch_multi_plot_FAST_spectrograms.py:88-93).
DEFAULT_SCALE_COMBOS: tuple[ScaleCombo, ...] = (
    ScaleCombo("linear", "linear", "viridis"),
    ScaleCombo("linear", "log", "cividis"),
    ScaleCombo("log", "linear", "plasma"),
    ScaleCombo("log", "log", "inferno"),
)


@dataclass
class FastBatchConfig:
    """Typed configuration for FAST batch directory runs.

    ``run()`` executes the orbit-major :func:`FAST_plot_spectrograms_multi`
    when ``schedule`` is ``"orbit-major"`` and there is more than one
    combo, else :func:`FAST_plot_spectrograms_directory` once per scale
    combo (the flagship CLI's loop); all fields map 1:1 to those drivers'
    keyword surfaces.
    """

    directory_path: str = FAST_CDF_DATA_FOLDER_PATH
    output_base: str = FAST_OUTPUT_BASE
    combos: tuple[ScaleCombo, ...] = DEFAULT_SCALE_COMBOS
    zoom_duration_minutes: float = DEFAULT_ZOOM_WINDOW_MINUTES
    instrument_order: tuple[str, ...] = DEFAULT_INSTRUMENT_ORDER
    progress_json_path: str | None = FAST_PLOTTING_PROGRESS_JSON
    ignore_progress_json: bool = False
    use_tqdm: bool = True
    cusp_marker_style: str = "both"
    cusp_marker_kwargs: dict = field(default_factory=dict)
    max_workers: int = 4
    orbit_timeout_seconds: float = 60
    instrument_timeout_seconds: float = 30
    retry_timeouts: bool = True
    flush_batch_size: int = 10
    max_processing_percentile: float | None = 99
    override_plots: bool = False
    verbose: bool = False
    #: "orbit-major" (default) interleaves every combo's jobs per orbit so a
    #: decoded CDF serves all combos while resident; "combo-major"
    #: reproduces the reference flagship's loop shape (outputs and progress
    #: state are identical either way).
    schedule: str = "orbit-major"

    def replace(self, **changes: Any) -> "FastBatchConfig":
        return dataclasses.replace(self, **changes)

    def run(self) -> list[dict[str, Any]]:
        from configurable_spectrograms_torch.fast.batch_directory import (
            FAST_plot_spectrograms_directory,
            FAST_plot_spectrograms_multi,
        )

        if self.schedule not in ("orbit-major", "combo-major"):
            raise ValueError(
                f"schedule must be 'orbit-major' or 'combo-major', got {self.schedule!r}"
            )
        common = dict(
            output_base=self.output_base,
            zoom_duration_minutes=self.zoom_duration_minutes,
            instrument_order=self.instrument_order,
            verbose=self.verbose,
            progress_json_path=self.progress_json_path,
            ignore_progress_json=self.ignore_progress_json,
            use_tqdm=self.use_tqdm,
            cusp_marker_style=self.cusp_marker_style,
            cusp_marker_kwargs=self.cusp_marker_kwargs,
            max_workers=self.max_workers,
            orbit_timeout_seconds=self.orbit_timeout_seconds,
            instrument_timeout_seconds=self.instrument_timeout_seconds,
            retry_timeouts=self.retry_timeouts,
            flush_batch_size=self.flush_batch_size,
            max_processing_percentile=self.max_processing_percentile,
            override_plots=self.override_plots,
        )
        if self.schedule == "orbit-major" and len(self.combos) > 1:
            return FAST_plot_spectrograms_multi(self.directory_path, combos=self.combos, **common)

        results: list[dict[str, Any]] = []
        for combo in self.combos:
            results += FAST_plot_spectrograms_directory(
                self.directory_path,
                y_scale=combo.y_scale,
                z_scale=combo.z_scale,
                colormap=combo.colormap,
                **common,
            )
        return results
