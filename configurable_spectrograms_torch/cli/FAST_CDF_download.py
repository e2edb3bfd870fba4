"""Download one year of FAST ESA CDF files from CDA Web (port of ``FAST_CDF_download.py``).

    python -m configurable_spectrograms_torch.cli.FAST_CDF_download [--year 1996..2008] \
        [--output_path DIR] [--instruments eeb ees ieb ies] [--base_url URL]

Same flags as the reference's script of this name
(reference FAST_CDF_download.py:38-85); a year outside the choices exits 2
before anything touches the network.
"""

from __future__ import annotations

import argparse

from configurable_spectrograms_torch.cli.common import run_cli
from configurable_spectrograms_torch.data import download as dl


def main() -> None:
    parser = argparse.ArgumentParser(description="Script to download FAST CDF files from CDA Web")
    parser.add_argument("--base_url", default=dl.FAST_ESA_BASE_URL, help="base URL to get the files")
    parser.add_argument(
        "--year",
        type=int,
        default=dl.DEFAULT_YEAR,
        choices=list(range(1996, 2009)),
        help="year of data to download",
    )
    parser.add_argument("--output_path", default=dl.DEFAULT_FOLDER, help="path to save the files")
    parser.add_argument(
        "--instruments",
        nargs="+",
        default=dl.DEFAULT_INSTRUMENT_LIST,
        choices=list(dl.INSTRUMENT_OPTIONS),
        help="instruments to download",
    )
    ns = parser.parse_args()
    dl.FAST_ESA_CDF_download(
        base_url=ns.base_url, year=ns.year, data_folder=ns.output_path, instruments=ns.instruments
    )


if __name__ == "__main__":
    run_cli(main)
