"""Shared utilities: device selection, logging, progress persistence, percentiles."""

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
    "configure_log_batch",
    "flush_log_buffer",
    "get_logfile_path",
    "log_error",
    "log_exception",
    "log_message",
    "set_logfile_path",
    "compute_percentile_bounds",
    "round_extrema",
    "terminate_all_child_processes",
]
