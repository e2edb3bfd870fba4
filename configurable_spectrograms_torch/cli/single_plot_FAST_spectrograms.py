"""Render one FAST ESA figure: a pitch-angle grid or an instrument grid (port of ``single_plot_FAST_spectrograms.py``).

    python -m configurable_spectrograms_torch.cli.single_plot_FAST_spectrograms --output out.png \
        (--cdf-file F | --data-folder DIR --orbit N | --instrument-file INST=PATH ... | --date YYYY-MM-DD
         [--download-folder DIR]) [--y-scale linear|log] [--z-scale linear|log] [--colormap NAME]
        [--cusp-style line|bracket|both]

Same mutually-exclusive modes, flags, 200 DPI saves, and exit codes as the
reference's script of this name (reference
single_plot_FAST_spectrograms.py:36-175): 0 = saved, 1 = nothing to plot,
2 = usage error, 130 = interrupted.
"""

from __future__ import annotations

import argparse

from configurable_spectrograms_torch.cli.common import add_render_style_arguments, report_render_outcome, run_cli
from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
from configurable_spectrograms_torch.data.orbit_discovery import (
    discover_orbit_files,
    extract_orbit_and_instrument,
    resolve_orbit_from_files,
)
from configurable_spectrograms_torch.fast.plotting import (
    FAST_plot_instrument_grid,
    FAST_plot_pitch_angle_grid,
)


def render_single_pitch_angle_grid(
    cdf_file_path: str,
    output_path: str,
    y_scale: str = "linear",
    z_scale: str = "linear",
    colormap: str = "viridis",
    cusp_marker_style: str = "both",
) -> bool:
    """One instrument file -> its pitch-angle grid PNG.

    The orbit number for cusp-boundary lookup parses from the filename.
    """
    parsed = extract_orbit_and_instrument(cdf_file_path)
    figure, _ = FAST_plot_pitch_angle_grid(
        cdf_file_path,
        filtered_orbits_df=load_filtered_orbits(),
        orbit_number=parsed[0] if parsed else None,
        scale_function_y=y_scale,
        scale_function_z=z_scale,
        show=False,
        colormap=colormap,
        cusp_marker_style=cusp_marker_style,
    )
    if figure is None:
        return False
    figure.savefig(output_path, dpi=200)
    return True


def render_single_instrument_grid(
    data_folder: str,
    orbit_number: int,
    output_path: str,
    y_scale: str = "linear",
    z_scale: str = "linear",
    colormap: str = "viridis",
    cusp_marker_style: str = "both",
) -> bool:
    """One orbit resolved from *data_folder* -> its instrument-grid PNG."""
    files = discover_orbit_files(data_folder).get(orbit_number)
    if not files:
        return False
    figure, _ = FAST_plot_instrument_grid(
        files,
        filtered_orbits_df=load_filtered_orbits(),
        orbit_number=orbit_number,
        scale_function_y=y_scale,
        scale_function_z=z_scale,
        show=False,
        colormap=colormap,
        cusp_marker_style=cusp_marker_style,
    )
    if figure is None:
        return False
    figure.savefig(output_path, dpi=200)
    return True


def render_single_instrument_grid_from_files(
    instrument_files: dict[str, str],
    output_path: str,
    y_scale: str = "linear",
    z_scale: str = "linear",
    colormap: str = "viridis",
    cusp_marker_style: str = "both",
) -> bool:
    """A caller-assembled ``{instrument: path}`` map -> instrument-grid PNG.

    The per-instrument file-picker source of the reference GUI's single-day
    page (reference GUI_batch_download_plot_FAST.py:1449-2031); the orbit
    for cusp lookup resolves from any parseable filename in the map.
    """
    if not instrument_files:
        return False
    figure, _ = FAST_plot_instrument_grid(
        instrument_files,
        filtered_orbits_df=load_filtered_orbits(),
        orbit_number=resolve_orbit_from_files(instrument_files),
        scale_function_y=y_scale,
        scale_function_z=z_scale,
        show=False,
        colormap=colormap,
        cusp_marker_style=cusp_marker_style,
        instrument_order=tuple(instrument_files),
    )
    if figure is None:
        return False
    figure.savefig(output_path, dpi=200)
    return True


def render_single_day_downloaded(
    date_str: str,
    output_path: str,
    data_folder: str = "./FAST_data/",
    instruments: tuple[str, ...] = ("ees", "eeb", "ies", "ieb"),
    y_scale: str = "linear",
    z_scale: str = "linear",
    colormap: str = "viridis",
    cusp_marker_style: str = "both",
    downloader=None,
) -> bool:
    """Download one calendar day's CDFs, then render its instrument grid.

    The download-by-date source of the reference GUI's single-day page.
    ``downloader`` (same contract as
    :func:`..data.download.download_single_day_cdf`) is injectable for
    offline use/tests.  When the day spans several orbits, the shared
    (most-covered) orbit is rendered.
    """
    import datetime as dt

    from configurable_spectrograms_torch.data.orbit_discovery import resolve_shared_orbit

    if downloader is None:
        from configurable_spectrograms_torch.data.download import download_single_day_cdf

        downloader = download_single_day_cdf
    date = dt.date.fromisoformat(date_str)
    by_instrument = downloader(date, instruments=list(instruments), data_folder=data_folder)
    orbit_number, files = resolve_shared_orbit(by_instrument)
    if orbit_number is None:
        return False
    return render_single_instrument_grid_from_files(
        files, output_path, y_scale, z_scale, colormap, cusp_marker_style
    )


def _parse_instrument_file_args(pairs: list[str], parser: argparse.ArgumentParser) -> dict[str, str]:
    files: dict[str, str] = {}
    for pair in pairs:
        if "=" not in pair:
            parser.error(f"--instrument-file expects INST=PATH, got {pair!r}")
        inst, _, path = pair.partition("=")
        files[inst.strip()] = path.strip()
    return files


def main() -> int:
    parser = argparse.ArgumentParser(description="Render a single FAST ESA spectrogram figure.")
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--cdf-file", help="Single CDF file to render as a pitch-angle grid.")
    mode.add_argument("--data-folder", help="Data folder to search for one orbit's instrument grid.")
    mode.add_argument(
        "--instrument-file", action="append", metavar="INST=PATH",
        help="Explicit per-instrument CDF (repeatable) for an instrument grid.",
    )
    mode.add_argument("--date", help="Download this day's CDFs (YYYY-MM-DD) and render its grid.")
    parser.add_argument("--orbit", type=int, help="Orbit number (required with --data-folder).")
    parser.add_argument("--download-folder", default="./FAST_data/",
                        help="Destination folder for --date downloads.")
    parser.add_argument("--output", required=True, help="Destination PNG file path.")
    add_render_style_arguments(parser)
    args = parser.parse_args()

    if args.data_folder is not None and args.orbit is None:
        parser.error("--orbit is required when using --data-folder")

    style = (args.y_scale, args.z_scale, args.colormap, args.cusp_style)
    if args.cdf_file is not None:
        produced = render_single_pitch_angle_grid(args.cdf_file, args.output, *style)
    elif args.instrument_file:
        produced = render_single_instrument_grid_from_files(
            _parse_instrument_file_args(args.instrument_file, parser), args.output, *style
        )
    elif args.date is not None:
        produced = render_single_day_downloaded(
            args.date, args.output, data_folder=args.download_folder,
            y_scale=args.y_scale, z_scale=args.z_scale,
            colormap=args.colormap, cusp_marker_style=args.cusp_style,
        )
    else:
        produced = render_single_instrument_grid(args.data_folder, args.orbit, args.output, *style)
    return report_render_outcome(produced, args.output)


if __name__ == "__main__":
    run_cli(main)
