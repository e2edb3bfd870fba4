"""FAST mission defaults: filesystem layout, instrument set, pitch categories.

Values match reference fast/constants.py:1-41 so progress files, extrema
caches, and output trees interchange between implementations.
"""

from configurable_spectrograms_torch import constants as _generic

# --- working-directory-relative file layout --------------------------------
# One place for every FAST state/output path; all are overridable at the
# driver keyword surfaces.
_PATHS = {
    "data": "./FAST_data/",
    "cusp_csv": "./FAST_Cusp_Indices.csv",
    "progress": "./batch_multi_plot_FAST_progress.json",
    "output": "./FAST_plots/",
    "log_prefix": "./batch_multi_plot_FAST_log",
    "log_marker": "./batch_multi_plot_FAST_logfile_datetime.txt",
    "extrema": "./FAST_calculated_extrema.json",
}

FAST_CDF_DATA_FOLDER_PATH = _PATHS["data"]
FAST_FILTERED_ORBITS_CSV_PATH = _PATHS["cusp_csv"]
FAST_PLOTTING_PROGRESS_JSON = _PATHS["progress"]
FAST_OUTPUT_BASE = _PATHS["output"]
FAST_LOGFILE_PREFIX = _PATHS["log_prefix"]
FAST_LOGFILE_DATETIME_MARKER_PATH = _PATHS["log_marker"]
FAST_EXTREMA_JSON_PATH = _PATHS["extrema"]

# --- instruments and variables ----------------------------------------------
CDF_VARIABLES = tuple(_generic.CDF_VARIABLE_NAMES)
DEFAULT_INSTRUMENT_ORDER = ("ees", "eeb", "ies", "ieb")

# --- per-scale-combo colormaps (aliases of the generic set) ------------------
DEFAULT_COLORMAP_LINEAR_Y_LINEAR_Z = _generic.COLORMAP_LINEAR_Y_LINEAR_Z
DEFAULT_COLORMAP_LINEAR_Y_LOG_Z = _generic.COLORMAP_LINEAR_Y_LOG_Z
DEFAULT_COLORMAP_LOG_Y_LINEAR_Z = _generic.COLORMAP_LOG_Y_LINEAR_Z
DEFAULT_COLORMAP_LOG_Y_LOG_Z = _generic.COLORMAP_LOG_Y_LOG_Z


def _categories() -> dict[str, list[tuple[float, float]]]:
    """Build the standard pitch-angle category table.

    Label text doubles as the row label (including the degree ranges on a
    second line), so the exact strings are part of the output contract.
    """
    spec = [
        ("downgoing", [(0.0, 30.0), (330.0, 360.0)]),
        ("upgoing", [(150.0, 210.0)]),
        ("perpendicular", [(40.0, 140.0), (210.0, 330.0)]),
        ("all", [(0.0, 360.0)]),
    ]
    table = {}
    for name, ranges in spec:
        pretty = ", ".join(f"({lo:g}, {hi:g})" for lo, hi in ranges)
        table[f"{name}\n{pretty}"] = ranges
    return table


#: Pitch-angle category boundaries (degrees) used when the caller supplies
#: no mapping of their own.
DEFAULT_PITCH_ANGLE_CATEGORIES: dict[str, list[tuple[float, float]]] = _categories()
