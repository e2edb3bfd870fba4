"""Helpers shared by every CLI entry point (port of ``cli/common.py``).

The reference's scripts each re-declare the same style flags and
exit-code conventions (e.g. reference single_plot_spectrogram.py:94-125);
this module centralizes them: scale/colormap/cusp-style arguments, the
"saved or warn" outcome report (exit 0 saved / 1 nothing to plot), and a
``run_cli`` wrapper providing the shared 130-on-interrupt behavior.
"""

from __future__ import annotations

import argparse
import sys
from collections.abc import Callable


def add_render_style_arguments(parser: argparse.ArgumentParser) -> None:
    """Attach the standard --y-scale/--z-scale/--colormap/--cusp-style flags."""
    parser.add_argument("--y-scale", choices=("linear", "log"), default="linear")
    parser.add_argument("--z-scale", choices=("linear", "log"), default="linear")
    parser.add_argument("--colormap", default="viridis")
    parser.add_argument("--cusp-style", choices=("line", "bracket", "both"), default="both")


def report_render_outcome(produced: bool, output_path: str) -> int:
    """Shared saved/no-data reporting: 0 when a figure was written, 1 otherwise."""
    if not produced:
        print("[WARNING] No data available to plot for the given input.")
        return 1
    print(f"[SAVED] {output_path}")
    return 0


def run_cli(main: Callable[[], int | None]) -> None:
    """Invoke *main*, translating Ctrl-C into the conventional exit code 130.

    A ``SystemExit`` (argparse errors, explicit exits) keeps its code, with
    ``sys.exit("message")`` semantics: a non-int payload prints to stderr
    and exits 1; ``None`` exits 0.  Ends in :func:`clean_exit`.
    """
    try:
        code = main()
    except KeyboardInterrupt:
        print("\n[INTERRUPT] Aborted by user.")
        code = 130
    except SystemExit as exc:
        code = exc.code
    if code is not None and not isinstance(code, int):
        print(code, file=sys.stderr)
        code = 1
    clean_exit(int(code or 0))


def clean_exit(code: int = 0) -> None:
    """Flush logs and stdio, then exit with *code* via ``os._exit``.

    Skipping interpreter teardown makes the exit code exactly *code*: no
    worker thread of a batch pool, atexit hook or CUDA context teardown can
    change it after the work finished.
    """
    import os

    from configurable_spectrograms_torch.utils.logging import flush_log_buffer

    try:
        flush_log_buffer(force=True)
    except Exception:
        pass
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(int(code))
