"""Command-line entry points of the port (``python -m configurable_spectrograms_torch.cli.<name>``)."""

from configurable_spectrograms_torch.cli.common import (
    add_render_style_arguments,
    clean_exit,
    report_render_outcome,
    run_cli,
)

__all__ = ["add_render_style_arguments", "clean_exit", "report_render_outcome", "run_cli"]
