"""Axis-limit rounding (host side).

Behavior matches reference percentile_utils.py:8-34.
"""

from __future__ import annotations

import math


def round_extrema(value: float, direction: str) -> float:
    """Round to the next significant digit so axis limits look clean.

    ``'up'`` ceils and ``'down'`` floors at one digit below the leading
    digit: 1234 rounds up to 1300 and down to 1200.

    Examples
    --------
    >>> round_extrema(1234, 'up')
    1300.0
    >>> round_extrema(0.0123, 'down')
    0.012
    """
    if value == 0:
        return 0.0
    if direction not in ("up", "down"):
        raise ValueError(f"Invalid direction: {direction}")
    scale = 10.0 ** (math.floor(math.log10(abs(value))) - 1)
    rounder = math.ceil if direction == "up" else math.floor
    return float(rounder(value / scale) * scale)
