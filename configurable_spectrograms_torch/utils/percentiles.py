"""Axis-limit rounding and percentile color-bound resolution (host side).

Behavior matches reference percentile_utils.py:8-89.
"""

from __future__ import annotations

import math

import numpy as np


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


def compute_percentile_bounds(
    matrix: np.ndarray,
    low_percentile: float = 1,
    high_percentile: float = 99,
    z_min: float | None = None,
    z_max: float | None = None,
) -> tuple[float, float]:
    """Resolve ``(z_min, z_max)`` color bounds, each independently.

    An explicit bound passes through; a missing one falls back to the
    matching ``numpy.nanpercentile`` of *matrix*.

    Examples
    --------
    >>> import numpy as np
    >>> compute_percentile_bounds(np.array([[1.0, 2.0, 3.0, 100.0]]), 0, 100)
    (1.0, 100.0)
    >>> compute_percentile_bounds(np.array([1.0, 2.0, 3.0]), z_min=-5.0, z_max=5.0)
    (-5.0, 5.0)
    """

    def resolve(explicit: float | None, q: float) -> float:
        return float(explicit) if explicit is not None else float(np.nanpercentile(matrix, q))

    return resolve(z_min, low_percentile), resolve(z_max, high_percentile)
