"""Download one calendar day of FAST ESA CDF files from CDA Web (port of ``single_day_FAST_CDF_download.py``).

    python -m configurable_spectrograms_torch.cli.single_day_FAST_CDF_download --date YYYY-MM-DD \
        [--output_path DIR] [--instruments eeb ees ieb ies] [--base_url URL]

Same flags, coverage-window validation, per-instrument counts, and exit
codes as the reference's script of this name
(reference single_day_FAST_CDF_download.py:41-109): 0 = files found,
1 = none for the day, 2 = usage error (a malformed date, or one outside
FAST's coverage, exits before anything touches the network).
"""

from __future__ import annotations

import argparse
import datetime as dt

from configurable_spectrograms_torch.cli.common import run_cli
from configurable_spectrograms_torch.data import download as dl


def _parse_date(text: str) -> dt.date:
    """``YYYY-MM-DD`` argument validated against FAST's coverage span."""
    try:
        day = dt.date.fromisoformat(text)
    except ValueError as exc:
        raise argparse.ArgumentTypeError(f"invalid date {text!r}; expected YYYY-MM-DD") from exc
    if not (dl.FAST_MIN_DATE <= day <= dl.FAST_MAX_DATE):
        raise argparse.ArgumentTypeError(
            f"{day.isoformat()} is outside FAST ESA CDF coverage "
            f"({dl.FAST_MIN_DATE.isoformat()} through {dl.FAST_MAX_DATE.isoformat()})"
        )
    return day


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Script to download one day of FAST CDF files from CDA Web"
    )
    parser.add_argument("--date", required=True, type=_parse_date, help="calendar day to download, YYYY-MM-DD")
    parser.add_argument("--base_url", default=dl.FAST_ESA_BASE_URL, help="base URL to get the files")
    parser.add_argument("--output_path", default=dl.DEFAULT_FOLDER, help="path to save the files")
    parser.add_argument(
        "--instruments",
        nargs="+",
        default=dl.DEFAULT_INSTRUMENT_LIST,
        choices=list(dl.INSTRUMENT_OPTIONS),
        help="instruments to download",
    )
    ns = parser.parse_args()

    fetched = dl.download_single_day_cdf(
        date=ns.date, instruments=ns.instruments, base_url=ns.base_url, data_folder=ns.output_path
    )
    if not any(fetched.values()):
        print(f"[WARNING] No FAST CDF files found for {ns.date.isoformat()}.")
        return 1
    for instrument, files in fetched.items():
        print(f"[{instrument}] {len(files)} file(s)")
    return 0


if __name__ == "__main__":
    run_cli(main)
