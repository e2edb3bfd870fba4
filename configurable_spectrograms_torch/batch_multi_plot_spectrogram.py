"""Backward-compatible re-export module for generic plotting/batch imports (port of ``batch_multi_plot_spectrogram.py``).

Pure re-export shim matching the reference's
``batch_multi_plot_spectrogram.py:39-97``, so
``from configurable_spectrograms_torch.batch_multi_plot_spectrogram import make_spectrogram``
gives the port's object.
"""

from configurable_spectrograms_torch.batch_runner import run_batch
from configurable_spectrograms_torch.constants import (
    CDF_DATA_DIRECTORY,
    CDF_VARIABLE_NAMES,
    COLLAPSE_MODE,
    COLORMAP_LINEAR_Y_LINEAR_Z,
    COLORMAP_LINEAR_Y_LOG_Z,
    COLORMAP_LOG_Y_LINEAR_Z,
    COLORMAP_LOG_Y_LOG_Z,
    FILTERED_ORBITS_CSV_PATH,
    OUTPUT_BASE_DIRECTORY,
    PLOTTING_PROGRESS_JSON_PATH,
)
from configurable_spectrograms_torch.data.cdf_utils import (
    get_cdf_file_type,
    get_cdf_var_shapes,
    get_timestamps_for_orbit,
    get_variable_shape,
    load_fast_cdf_dataset,
    load_filtered_orbits,
)
from configurable_spectrograms_torch.generic_batch import generic_batch_plot
from configurable_spectrograms_torch.render.cusp import (
    draw_cusp_both_markers,
    draw_cusp_bracket_marker,
    draw_cusp_line_markers,
)
from configurable_spectrograms_torch.render.plotting import (
    close_all_axes_and_clear,
    generic_plot_multirow_optional_zoom,
    generic_plot_spectrogram_set,
    make_spectrogram,
)
from configurable_spectrograms_torch.utils.logging import (
    configure_log_batch,
    flush_log_buffer,
    get_logfile_path,
    log_error,
    log_exception,
    log_message,
    set_logfile_path,
)
from configurable_spectrograms_torch.utils.percentiles import (
    compute_percentile_bounds,
    round_extrema,
)
from configurable_spectrograms_torch.utils.process import terminate_all_child_processes

__all__ = [
    "CDF_DATA_DIRECTORY",
    "CDF_VARIABLE_NAMES",
    "COLLAPSE_MODE",
    "COLORMAP_LINEAR_Y_LINEAR_Z",
    "COLORMAP_LINEAR_Y_LOG_Z",
    "COLORMAP_LOG_Y_LINEAR_Z",
    "COLORMAP_LOG_Y_LOG_Z",
    "FILTERED_ORBITS_CSV_PATH",
    "OUTPUT_BASE_DIRECTORY",
    "PLOTTING_PROGRESS_JSON_PATH",
    "close_all_axes_and_clear",
    "compute_percentile_bounds",
    "configure_log_batch",
    "draw_cusp_both_markers",
    "draw_cusp_bracket_marker",
    "draw_cusp_line_markers",
    "flush_log_buffer",
    "generic_batch_plot",
    "generic_plot_multirow_optional_zoom",
    "generic_plot_spectrogram_set",
    "get_cdf_file_type",
    "get_cdf_var_shapes",
    "get_logfile_path",
    "get_timestamps_for_orbit",
    "get_variable_shape",
    "load_fast_cdf_dataset",
    "load_filtered_orbits",
    "log_error",
    "log_exception",
    "log_message",
    "make_spectrogram",
    "round_extrema",
    "run_batch",
    "set_logfile_path",
    "terminate_all_child_processes",
]
