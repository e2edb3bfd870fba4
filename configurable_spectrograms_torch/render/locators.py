"""Tick locators and formatters (matplotlib-equivalent behavior, no mpl).

Covers the four tick systems the reference's figures use:

* UTC time axis with the reference's span-dependent %H:%M:%S / %H:%M
  format rule (reference plotting.py:355-363)
* linear "nice number" ticks (matplotlib MaxNLocator-style) for colorbars
* log-scale power-of-10 ticks with the reference's formatter that labels
  only exact powers (reference plotting.py:288-298)
* the reference's bespoke linear-y tick synthesis from the leading digits
  of ``y_axis_max`` (reference plotting.py:336-351)
"""

from __future__ import annotations

import math
from datetime import datetime, timezone

_NICE_STEPS = (1.0, 2.0, 2.5, 5.0, 10.0)

#: Candidate time-tick intervals in seconds (sub-second through days).
_TIME_STEPS = (
    0.1,
    0.2,
    0.5,
    1,
    2,
    5,
    10,
    15,
    30,
    60,
    120,
    300,
    600,
    900,
    1800,
    3600,
    7200,
    10800,
    21600,
    43200,
    86400,
)


def nice_linear_ticks(vmin: float, vmax: float, max_ticks: int = 6) -> list[float]:
    """Nice-number ticks inside [vmin, vmax] (MaxNLocator-like)."""
    if not (math.isfinite(vmin) and math.isfinite(vmax)) or vmax <= vmin:
        return [vmin] if math.isfinite(vmin) else []
    raw_step = (vmax - vmin) / max(1, max_ticks)
    mag = 10 ** math.floor(math.log10(raw_step)) if raw_step > 0 else 1.0
    step = next((s * mag for s in _NICE_STEPS if s * mag >= raw_step), 10 * mag)
    first = math.ceil(vmin / step) * step
    ticks = []
    v = first
    while v <= vmax + step * 1e-9:
        ticks.append(0.0 if abs(v) < step * 1e-9 else v)
        v += step
    return ticks


def format_linear_tick(value: float, step_hint: float | None = None) -> str:
    """Compact numeric label: integers without decimals, short floats else."""
    if value == int(value) and abs(value) < 1e16:
        return str(int(value))
    txt = f"{value:.6g}"
    return txt


def log_ticks(vmin: float, vmax: float) -> list[int]:
    """Exponents k with ``vmin <= 10**k <= vmax`` (reference plotting.py:288-290)."""
    if vmin <= 0 or vmax <= 0 or vmax < vmin:
        return []
    min_exponent = int(math.floor(math.log10(vmin)))
    max_exponent = int(math.ceil(math.log10(vmax)))
    return [k for k in range(min_exponent, max_exponent + 1) if vmin <= 10**k <= vmax]


def time_ticks(x0: float, x1: float, max_ticks: int = 7) -> tuple[list[float], str]:
    """UTC time ticks in unix seconds plus the reference's format rule.

    Tick positions are multiples of a nice interval (UTC-aligned, as the
    chosen intervals all divide a day); format is ``%H:%M:%S`` when the
    displayed span is under 120 s, else ``%H:%M``
    (reference plotting.py:355-363).
    """
    span = x1 - x0
    fmt = "%H:%M:%S" if span < 120 else "%H:%M"
    if span <= 0:
        return [x0], fmt
    step = next((s for s in _TIME_STEPS if span / s <= max_ticks), 86400.0)
    while span / step > max_ticks:
        step *= 2
    first = math.ceil(x0 / step) * step
    ticks = []
    v = first
    while v <= x1 + step * 1e-9:
        ticks.append(v)
        v += step
    return ticks, fmt


def format_time_tick(unix_seconds: float, fmt: str) -> str:
    return datetime.fromtimestamp(unix_seconds, tz=timezone.utc).strftime(fmt)


def synthesize_linear_y_ticks(y_axis_min: float, y_axis_max: float) -> list[int]:
    """The reference's linear-y tick synthesis from leading digits.

    Derives a step size and top tick from the first two characters of
    ``str(y_axis_max)`` and emits integer ticks from ``y_axis_min`` filtered
    to <= 1.1x the top tick (reference plotting.py:336-351).  Float inputs
    are coerced to int first (the reference's ``range`` call requires ints).

    Examples
    --------
    >>> synthesize_linear_y_ticks(0, 4000)
    [0, 1000, 2000, 3000, 4000]
    >>> synthesize_linear_y_ticks(0, 1400)
    [0, 1000]
    """
    y_max_int = int(y_axis_max)
    y_min_int = int(y_axis_min)
    if y_max_int <= 0:
        # Deliberate divergence: the reference's digit heuristic does
        # int('-') and crashes the whole figure save for negative maxima
        # (reference plotting.py:338-340, reachable only via generic
        # datasets); render endpoint ticks instead.
        return sorted({y_min_int, y_max_int})
    y_max_str = str(y_max_int)
    if len(y_max_str) < 2:
        return [t for t in (y_min_int, y_max_int) if t <= y_max_int]
    y_max_digits = len(y_max_str)
    y_first_digit = int(y_max_str[0])
    y_second_digit = int(y_max_str[1])
    if y_second_digit >= 5:
        step_size = 10**y_max_digits
        y_max_tick = y_first_digit * 10 ** (y_max_digits - 1)
    else:
        step_size = 10 ** (y_max_digits - 1)
        y_max_tick = (y_first_digit + 0.5) * 10 ** (y_max_digits - 1)
    return [i for i in range(y_min_int, int(y_max_tick) + 1, step_size) if (i / y_max_tick) <= 1.1]
