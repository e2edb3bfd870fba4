"""Batch-plot every FAST orbit in a directory across all four scale combos (port of ``batch_multi_plot_FAST_spectrograms.py``).

    python -m configurable_spectrograms_torch.cli.batch_multi_plot_FAST_spectrograms

Takes no flags, like the reference's script of this name: it reads
``./FAST_data/`` and ``./FAST_Cusp_Indices.csv`` from the working
directory and writes ``./FAST_plots/``, the progress JSON, the extrema
JSON and a log there.  The same public re-exports for compatibility
imports, and a ``main`` that runs the batch driver per (y, z) scale
combination with its matched colormap, a 99th-percentile extrema
pre-pass, and existing plots skipped
(reference batch_multi_plot_FAST_spectrograms.py:58-112).
``CST_BATCH_SCHEDULE`` picks ``orbit-major`` (default) or ``combo-major``.

On several GPUs, start one rank per card::

    torchrun --nproc-per-node N -m configurable_spectrograms_torch.cli.batch_multi_plot_FAST_spectrograms

Under torchrun (``WORLD_SIZE`` > 1) ``main`` joins the process group
(:func:`..parallel.mesh.init_distributed`: NCCL, rank ``r`` on
``cuda:{LOCAL_RANK}``) before the driver and leaves it at the end.  Rank
``r`` of ``n`` plots orbits ``r::n`` of the sorted archive and keeps its
own state files, the progress and extrema JSONs suffixed ``.proc{r}``; each
rank runs the extrema pre-pass over the whole archive, as every host of
the JAX package does.
"""

from __future__ import annotations

import os

from configurable_spectrograms_torch.cli.common import run_cli
from configurable_spectrograms_torch.data.orbit_discovery import extract_orbit_and_instrument
from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_directory
from configurable_spectrograms_torch.fast.constants import (
    CDF_VARIABLES,
    DEFAULT_COLORMAP_LINEAR_Y_LINEAR_Z,
    DEFAULT_COLORMAP_LINEAR_Y_LOG_Z,
    DEFAULT_COLORMAP_LOG_Y_LINEAR_Z,
    DEFAULT_COLORMAP_LOG_Y_LOG_Z,
    DEFAULT_INSTRUMENT_ORDER,
    FAST_CDF_DATA_FOLDER_PATH,
    FAST_FILTERED_ORBITS_CSV_PATH,
    FAST_LOGFILE_DATETIME_MARKER_PATH,
    FAST_LOGFILE_PREFIX,
    FAST_OUTPUT_BASE,
    FAST_PLOTTING_PROGRESS_JSON,
)
from configurable_spectrograms_torch.fast.extrema import compute_global_extrema
from configurable_spectrograms_torch.fast.plotting import (
    FAST_plot_instrument_grid,
    FAST_plot_pitch_angle_grid,
)
from configurable_spectrograms_torch.fast.process_orbit import FAST_process_single_orbit
from configurable_spectrograms_torch.parallel.mesh import init_distributed, process_group_ready, shutdown_distributed
from configurable_spectrograms_torch.utils.config import FastBatchConfig
from configurable_spectrograms_torch.utils.logging import (
    get_logfile_path,
    log_exception,
    set_logfile_path,
)
from configurable_spectrograms_torch.utils.percentiles import round_extrema

__all__ = [
    "CDF_VARIABLES",
    "DEFAULT_COLORMAP_LINEAR_Y_LINEAR_Z",
    "DEFAULT_COLORMAP_LINEAR_Y_LOG_Z",
    "DEFAULT_COLORMAP_LOG_Y_LINEAR_Z",
    "DEFAULT_COLORMAP_LOG_Y_LOG_Z",
    "DEFAULT_INSTRUMENT_ORDER",
    "FAST_CDF_DATA_FOLDER_PATH",
    "FAST_FILTERED_ORBITS_CSV_PATH",
    "FAST_OUTPUT_BASE",
    "FAST_PLOTTING_PROGRESS_JSON",
    "FAST_plot_instrument_grid",
    "FAST_plot_pitch_angle_grid",
    "FAST_plot_spectrograms_directory",
    "FAST_process_single_orbit",
    "compute_global_extrema",
    "extract_orbit_and_instrument",
    "round_extrema",
]


def main() -> None:
    """Run the flagship batch for all four scale combos, resumably.

    An interrupt during any combo stops the sequence (KeyboardInterrupt
    propagates out of the driver).
    """
    set_logfile_path(get_logfile_path(FAST_LOGFILE_PREFIX, FAST_LOGFILE_DATETIME_MARKER_PATH))
    # The reference CLI is flagless (reference
    # batch_multi_plot_FAST_spectrograms.py:79-103), so the scheduling
    # choice rides an env knob instead of a new argument.
    schedule = os.environ.get("CST_BATCH_SCHEDULE") or "orbit-major"
    grouped = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not process_group_ready()
    if grouped:
        init_distributed()
    try:
        FastBatchConfig(schedule=schedule).run()
    except KeyboardInterrupt:
        log_exception("[INTERRUPT] Batch plotting aborted by user.", level="message")
        raise
    finally:
        if grouped:
            shutdown_distributed()


if __name__ == "__main__":
    run_cli(main)
