"""Shared constants for spectrogram plotting and batch processing.

Semantics-parity with the reference's ``constants.py``
(reference src/configurable_spectrograms/constants.py:1-34), with the
matplotlib-specific collapse callable replaced by a named mode consumed by
the device kernels in :mod:`configurable_spectrograms_torch.ops`.
"""

import os

#: Directory containing CDF data files.
CDF_DATA_DIRECTORY = "./FAST_data/"

#: List of variable names expected in CDF files.
CDF_VARIABLE_NAMES = ["time_unix", "data", "energy", "pitch_angle"]

#: Collapse mode used to reduce a 3D data array down to 2D (over pitch
#: angle).  ``"nansum"`` matches the reference's ``np.nansum`` default; the
#: device kernels also accept ``"nanmean"`` / ``"nanmax"``.
COLLAPSE_MODE = "nansum"

# Colormaps for different axis-scaling combinations (colorblind-friendly
# and visually distinct).  Same mapping as the reference
# (reference constants.py:15-19).
COLORMAP_LINEAR_Y_LINEAR_Z = "viridis"
COLORMAP_LINEAR_Y_LOG_Z = "cividis"
COLORMAP_LOG_Y_LINEAR_Z = "plasma"
COLORMAP_LOG_Y_LOG_Z = "inferno"

# Plot configuration (reference constants.py:21-26).
PLOT_FIGURE_WIDTH_INCHES = 6.25
PLOT_FIGURE_HEIGHT_INCHES = 2.0
TICK_LABEL_FONT_SIZE = 15
AXIS_LABEL_FONT_SIZE = 18
DEFAULT_ZOOM_WINDOW_MINUTES = 6  # Default zoom window duration in minutes.

#: Path to the filtered cusp orbits CSV.
FILTERED_ORBITS_CSV_PATH = "./FAST_Cusp_Indices.csv"

#: Path to JSON tracking generic batch-plotting progress across sessions.
PLOTTING_PROGRESS_JSON_PATH = "./batch_multi_plot_progress.json"

#: Parent directory for generic batch-plot output.
OUTPUT_BASE_DIRECTORY = "./plots/"

#: Default DPI used when saving figures (FAST grids / generic sets),
#: matching reference fast/process_orbit.py:110 and generic_batch.py:113.
#: ``CST_FAST_SAVE_DPI`` overrides for smoke runs (e.g. the multi-chip
#: dry run renders the full driver path at a small DPI).
try:
    FAST_SAVE_DPI = int(os.environ.get("CST_FAST_SAVE_DPI", 200))
except ValueError:  # malformed override must not kill every import
    FAST_SAVE_DPI = 200
GENERIC_SAVE_DPI = 150
