"""Render one generic spectrogram figure from one CDF file (port of ``single_plot_spectrogram.py``).

    python -m configurable_spectrograms_torch.cli.single_plot_spectrogram --cdf-file f.cdf --output out.png \
        [--y-scale linear|log] [--z-scale linear|log] [--colormap NAME] [--cusp-style line|bracket|both]

Same flags and exit codes as the reference's script of this name
(reference single_plot_spectrogram.py:94-125): 0 = saved, 1 = nothing to
plot (a missing or unreadable CDF included), 130 = interrupted.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from configurable_spectrograms_torch.cli.common import add_render_style_arguments, report_render_outcome, run_cli
from configurable_spectrograms_torch.data.cdf_utils import load_fast_cdf_dataset
from configurable_spectrograms_torch.render.plotting import generic_plot_spectrogram_set


def render_single_spectrogram(
    cdf_file_path: str,
    output_path: str,
    y_scale: str = "linear",
    z_scale: str = "linear",
    colormap: str = "viridis",
    cusp_marker_style: str = "both",
    vertical_lines: list[float] | None = None,
) -> bool:
    """One CDF -> a single-row generic spectrogram PNG at 150 DPI.

    The CDF must hold the standard ``time_unix``/``data``/``energy``/
    ``pitch_angle`` variables.  Returns whether a figure was written; a
    missing or unreadable file reports "nothing to plot" (exit 1) instead
    of a traceback.
    """
    from configurable_spectrograms_torch.data.cdf.reader import CDFError
    from configurable_spectrograms_torch.utils.logging import log_error

    try:
        loaded = load_fast_cdf_dataset(cdf_file_path)
    except (OSError, CDFError, KeyError, ValueError) as exc:
        log_error(f"[ERROR] Could not load {cdf_file_path}: {exc}")
        return False
    row = {
        "x": loaded["times"],
        "y": loaded["energy"],
        "data": loaded["data"],
        "label": Path(cdf_file_path).stem,
    }
    figure, _ = generic_plot_spectrogram_set(
        [row],
        vertical_lines=vertical_lines,
        y_scale=y_scale,
        z_scale=z_scale,
        colormap=colormap,
        cusp_marker_style=cusp_marker_style,
        show=False,
    )
    if figure is None:
        return False
    figure.savefig(output_path, dpi=150)
    return True


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Render a single generic spectrogram figure from one CDF file."
    )
    parser.add_argument("--cdf-file", required=True, help="Path to the CDF file to plot.")
    parser.add_argument("--output", required=True, help="Destination PNG file path.")
    add_render_style_arguments(parser)
    args = parser.parse_args()

    produced = render_single_spectrogram(
        args.cdf_file,
        args.output,
        y_scale=args.y_scale,
        z_scale=args.z_scale,
        colormap=args.colormap,
        cusp_marker_style=args.cusp_style,
    )
    return report_render_outcome(produced, args.output)


if __name__ == "__main__":
    run_cli(main)
