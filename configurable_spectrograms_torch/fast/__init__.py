"""FAST mission layer: pitch-angle/instrument grids, extrema, batch driver."""

from configurable_spectrograms_torch.fast.batch_directory import (
    FAST_plot_spectrograms_directory,
    FAST_plot_spectrograms_multi,
)
from configurable_spectrograms_torch.fast.extrema import compute_global_extrema, extrema_overrides
from configurable_spectrograms_torch.fast.plotting import (
    FAST_plot_instrument_grid,
    FAST_plot_pitch_angle_grid,
)
from configurable_spectrograms_torch.fast.process_orbit import FAST_process_single_orbit

__all__ = [
    "FAST_plot_spectrograms_directory",
    "FAST_plot_spectrograms_multi",
    "compute_global_extrema",
    "extrema_overrides",
    "FAST_plot_instrument_grid",
    "FAST_plot_pitch_angle_grid",
    "FAST_process_single_orbit",
]
