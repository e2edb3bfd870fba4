"""FAST ESA CDF downloads from CDA Web (single day, full year, threaded batch).

Port of the JAX package's ``data/download.py``; behavioral parity with
reference download.py:16-297.  ``requests`` and ``beautifulsoup4`` are
imported inside the functions that touch the network, and ``tqdm`` only
for the year loop's optional progress bar, so the rest of the package
works in network-free environments.
"""

from __future__ import annotations

import calendar
import datetime as dt
import functools
import os
from concurrent.futures import ThreadPoolExecutor

from configurable_spectrograms_torch.batch_runner import run_batch
from configurable_spectrograms_torch.utils.logging import log_error
from configurable_spectrograms_torch.utils.progress import tqdm_or_none

FAST_ESA_BASE_URL: str = "https://cdaweb.gsfc.nasa.gov/pub/data/fast/esa/l2"
INSTRUMENT_OPTIONS: set[str] = {"eeb", "ees", "ieb", "ies"}  # FAST also has "esv"
DEFAULT_INSTRUMENT_LIST: list[str] = sorted(INSTRUMENT_OPTIONS)
DEFAULT_YEAR: int = 2000
DEFAULT_FOLDER: str = "./FAST_data/"
#: CDA Web's FAST ESA coverage span (first/last day with any data).
FAST_MIN_DATE: dt.date = dt.date(1996, 8, 21)
FAST_MAX_DATE: dt.date = dt.date(2009, 5, 4)


def _month_url(base_url: str, instrument: str, year: int, month: str) -> str:
    return f"{base_url}/{instrument}/{year}/{month}"


def _month_dir(data_folder: str, year: int, month: str) -> str:
    folder = f"{data_folder}/{year}/{month}"
    os.makedirs(folder, exist_ok=True)
    return folder


def _download_single_cdf_file(download_link: str, output_file: str) -> None:
    """Fetch one CDF to disk, streamed in 4 KiB chunks when sized.

    Servers that omit Content-Length fall back to one buffered write.
    """
    import requests

    response = requests.get(download_link, stream=True)
    sized = response.headers.get("content-length") is not None
    with open(output_file, "wb") as f:
        if sized:
            for chunk in response.iter_content(chunk_size=4096):
                f.write(chunk)
        else:
            f.write(response.content)


def _list_instrument_page_files(page: str) -> list[str]:
    """Names of every ``.cdf`` link on one CDA Web month-listing page."""
    import requests
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(requests.get(page).content, "html.parser")
    names = []
    for anchor in soup.find_all("a"):
        href = anchor.get("href")
        if isinstance(href, str) and ".cdf" in href:
            names.append(href)
    return names


def _matches_day(file_name: str, instrument: str, date_str: str) -> bool:
    """Whether *file_name* is this instrument's CDF for the ``YYYYMMDD`` day.

    Examples
    --------
    >>> _matches_day("fa_esa_l2_eeb_20000101001737_13312_v02.cdf", "eeb", "20000101")
    True
    >>> _matches_day("fa_esa_l2_eeb_20000102001737_13313_v02.cdf", "eeb", "20000101")
    False
    >>> _matches_day("fa_esa_l2_ies_20000101001737_13312_v02.cdf", "eeb", "20000101")
    False
    """
    return file_name.endswith(".cdf") and f"_{instrument}_{date_str}" in file_name


def download_single_day_cdf(
    date: dt.date,
    instruments: list[str] = DEFAULT_INSTRUMENT_LIST,
    base_url: str = FAST_ESA_BASE_URL,
    data_folder: str = DEFAULT_FOLDER,
    _page_file_names: dict[str, list[str]] | None = None,
) -> dict[str, list[str]]:
    """Fetch every FAST ESA CDF for one calendar day, per instrument.

    Files land under ``{data_folder}/{year}/{month:02d}/``; files already
    on disk are kept, not re-fetched.  ``_page_file_names`` lets the year
    loop reuse one scraped listing per month instead of re-requesting it
    per day (reference download.py:84-143).  Returns
    ``{instrument: sorted local paths}`` (a day often spans several
    orbits, so lists may hold more than one file).
    """
    month = f"{date.month:02d}"
    day_tag = date.strftime("%Y%m%d")
    dest = _month_dir(data_folder, date.year, month)

    by_instrument: dict[str, list[str]] = {}
    for instrument in instruments:
        page = _month_url(base_url, instrument, date.year, month)
        names = (
            _page_file_names.get(instrument, [])
            if _page_file_names is not None
            else _list_instrument_page_files(page)
        )
        local: list[str] = []
        for name in names:
            if not _matches_day(name, instrument, day_tag):
                continue
            target = f"{dest}/{name}"
            if not os.path.exists(target):
                _download_single_cdf_file(f"{page}/{name}", target)
            local.append(target)
        by_instrument[instrument] = sorted(local)
    return by_instrument


def FAST_ESA_CDF_download(
    base_url: str = FAST_ESA_BASE_URL,
    year: int = DEFAULT_YEAR,
    data_folder: str = DEFAULT_FOLDER,
    instruments: list[str] = DEFAULT_INSTRUMENT_LIST,
) -> None:
    """Fetch one calendar year, scraping each month listing exactly once.

    Every day routes through :func:`download_single_day_cdf` against the
    cached listing, so single-day and full-year downloads share one code
    path (reference download.py:146-193).
    """
    tqdm = tqdm_or_none()
    for month_num in range(1, 13):
        month = f"{month_num:02d}"
        print(f"STATUS: Loading month listing pages for {year}-{month}")
        listings = {
            inst: _list_instrument_page_files(_month_url(base_url, inst, year, month))
            for inst in instruments
        }
        print(f"{month_num}/12 | downloading files for {year}-{month}")
        days = range(1, calendar.monthrange(year, month_num)[1] + 1)
        for day in days if tqdm is None else tqdm(days):
            download_single_day_cdf(
                date=dt.date(year, month_num, day),
                instruments=instruments,
                base_url=base_url,
                data_folder=data_folder,
                _page_file_names=listings,
            )


def _discover_download_targets(
    base_url: str, years: list[int], instruments: set[str], data_folder: str
) -> list[tuple[str, str]]:
    """(link, local path) pairs for every listed file not already on disk."""
    targets: list[tuple[str, str]] = []
    for year in years:
        for month_num in range(1, 13):
            month = f"{month_num:02d}"
            for instrument in instruments:
                dest = _month_dir(data_folder, year, month)
                page = _month_url(base_url, instrument, year, month)
                try:
                    names = _list_instrument_page_files(page)
                except Exception as exc:
                    log_error(f"[DOWNLOAD] Failed to load listing page {page}: {exc}")
                    continue
                targets += [
                    (f"{page}/{name}", f"{dest}/{name}")
                    for name in names
                    if not os.path.exists(f"{dest}/{name}")
                ]
    return targets


def download_cdf_files_threaded(
    base_url: str = FAST_ESA_BASE_URL,
    years: list[int] | None = None,
    data_folder: str = DEFAULT_FOLDER,
    instruments: set[str] = INSTRUMENT_OPTIONS,
    max_workers: int = 8,
    progress_json_path: str | None = None,
    ignore_progress_json: bool = False,
    flush_batch_size: int = 25,
) -> list[tuple[tuple[str, str], str]]:
    """Multi-year download through a thread pool (I/O-bound fan-out).

    Listings scrape sequentially (one small page per year/month/instrument),
    then :func:`run_batch` dispatches the individual file fetches to a
    ``ThreadPoolExecutor`` with resumable progress (reference
    download.py:230-297).  Returns ``((link, path), 'ok'|'error')`` pairs.
    """
    targets = _discover_download_targets(
        base_url, years if years is not None else [DEFAULT_YEAR], instruments, data_folder
    )

    def fetch(target: tuple[str, str]) -> tuple[tuple[str, str], str]:
        link, path = target
        try:
            _download_single_cdf_file(link, path)
            return (target, "ok")
        except Exception as exc:
            log_error(f"[DOWNLOAD-FAIL] {link}: {exc}")
            return (target, "error")

    return run_batch(
        targets,
        fetch,
        functools.partial(ThreadPoolExecutor, max_workers=max_workers),
        progress_json_path=progress_json_path,
        ignore_progress_json=ignore_progress_json,
        flush_batch_size=flush_batch_size,
    )
