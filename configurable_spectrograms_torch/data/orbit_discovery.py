"""FAST orbit/instrument file discovery and error-key helpers.

Behavioral parity with reference fast/orbit_discovery.py:12-250.
"""

from __future__ import annotations

import os
from pathlib import Path

from configurable_spectrograms_torch.data.cdf_utils import get_cdf_file_type
from configurable_spectrograms_torch.utils.logging import log_exception

DEFAULT_INSTRUMENT_ORDER = ("ees", "eeb", "ies", "ieb")

#: Error-message substrings -> progress-key reason tokens, checked in order.
_REASON_RULES = (
    (("divide", "zero"), "divide-by-zero"),
    (("invalid", "cdf"), "invalid-cdf"),
    (("timeout",), "timeout"),
    (("plot",), "plotting"),
)


def parse_year_month(file_path: str) -> tuple[str, str]:
    """``(year, month)`` from the first YYYY/MM directory pair in a path.

    Examples
    --------
    >>> parse_year_month("./FAST_data/2000/01/fa_esa_l2_eeb_20000101001737_13312_v02.cdf")
    ('2000', '01')
    >>> parse_year_month("no_year_here.cdf")
    ('unknown', 'unknown')
    """
    parts = Path(file_path).parts
    for i, part in enumerate(parts):
        if len(part) == 4 and part.isdigit():
            follower = parts[i + 1] if i + 1 < len(parts) else ""
            return part, follower if (len(follower) == 2 and follower.isdigit()) else "unknown"
    return "unknown", "unknown"


def classify_error_reason(msg: str) -> str:
    """Short reason token for an error message (progress-JSON taxonomy).

    Examples
    --------
    >>> classify_error_reason("divide by zero encountered")
    'divide-by-zero'
    >>> classify_error_reason("Timeout while processing orbit")
    'timeout'
    >>> classify_error_reason("something else entirely")
    'generic'
    """
    lowered = msg.lower()
    for needles, token in _REASON_RULES:
        if all(n in lowered for n in needles):
            return token
    return "generic"


def extract_orbit_and_instrument(cdf_path: str) -> tuple[int, str, str] | None:
    """``(orbit_number, instrument, path)`` parsed from a FAST CDF filename.

    The orbit number is the second-to-last underscore field; files that
    don't fit the pattern, fail to parse, or are ephemeris (``orb``) files
    resolve to ``None``.

    Examples
    --------
    >>> extract_orbit_and_instrument("fa_esa_l2_eeb_20000101001737_13312_v02.cdf")
    (13312, 'eeb', 'fa_esa_l2_eeb_20000101001737_13312_v02.cdf')
    >>> extract_orbit_and_instrument("fa_k0_orb_13312_v01.cdf") is None
    True
    """
    fields = os.path.basename(cdf_path).split("_")
    if len(fields) < 5:
        return None
    try:
        orbit = int(fields[-2])
    except ValueError as exc:
        log_exception(
            f"[ERROR] Invalid orbit number in filename: {os.path.basename(cdf_path)}", exc, level="message"
        )
        return None
    instrument = get_cdf_file_type(cdf_path)
    if instrument in (None, "orb"):
        return None
    return orbit, instrument, cdf_path


def discover_orbit_files(
    directory_path: str, instrument_order: tuple[str, ...] = DEFAULT_INSTRUMENT_ORDER
) -> dict[int, dict[str, str]]:
    """Recursively group instrument CDFs under a folder by orbit number.

    Paths containing ``_orb_`` (ephemeris) are excluded, instruments
    outside *instrument_order* are skipped, and the last file seen wins
    for duplicate (orbit, instrument) pairs
    (reference fast/orbit_discovery.py:129-166).
    """
    found: dict[int, dict[str, str]] = {}
    for entry in Path(directory_path).rglob("*.[cC][dD][fF]"):
        path = str(entry)
        if "_orb_" in path.lower():
            continue
        parsed = extract_orbit_and_instrument(path)
        if parsed is None or parsed[1] not in instrument_order:
            continue
        orbit, instrument, _ = parsed
        found.setdefault(orbit, {})[instrument] = path
    return found


def resolve_shared_orbit(instrument_day_files: dict[str, list[str]]) -> tuple[int | None, dict[str, str]]:
    """Reduce a day's downloads to the orbit covered by the most instruments.

    Ties break toward the lowest orbit number; instruments without a file
    for the winning orbit are omitted (reference fast/orbit_discovery.py:169-216).

    Examples
    --------
    >>> resolve_shared_orbit({
    ...     "eeb": ["fa_esa_l2_eeb_20000101001737_100_v02.cdf",
    ...             "fa_esa_l2_eeb_20000101031737_101_v02.cdf"],
    ...     "ies": ["fa_esa_l2_ies_20000101001738_100_v02.cdf"],
    ... })
    (100, {'eeb': 'fa_esa_l2_eeb_20000101001737_100_v02.cdf', 'ies': 'fa_esa_l2_ies_20000101001738_100_v02.cdf'})
    >>> resolve_shared_orbit({"eeb": [], "ies": []})
    (None, {})
    """
    per_orbit: dict[int, dict[str, str]] = {}
    for paths in instrument_day_files.values():
        for path in paths:
            parsed = extract_orbit_and_instrument(path)
            if parsed is not None:
                per_orbit.setdefault(parsed[0], {})[parsed[1]] = parsed[2]
    if not per_orbit:
        return None, {}
    winner = max(per_orbit, key=lambda orbit: (len(per_orbit[orbit]), -orbit))
    return winner, per_orbit[winner]


def resolve_orbit_from_files(instrument_files: dict[str, str]) -> int | None:
    """Best-effort orbit number from a caller-assembled instrument file map.

    Examples
    --------
    >>> resolve_orbit_from_files({"eeb": "fa_esa_l2_eeb_20000101001737_13312_v02.cdf"})
    13312
    >>> resolve_orbit_from_files({"eeb": "not_a_fast_file.cdf"}) is None
    True
    """
    return next(
        (parsed[0] for path in instrument_files.values() if (parsed := extract_orbit_and_instrument(path))),
        None,
    )
