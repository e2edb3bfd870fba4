"""Exact pooled percentiles over an incrementally growing sample pool.

The extrema pre-pass's z-bounds are percentiles of every positive collapsed
sample pooled across an archive (reference fast/extrema.py:280-285 keeps
the whole pool in memory and calls ``np.nanpercentile`` per orbit).  The
histogram summary (:mod:`.extrema_ops`) bounds that within one bin
(<1.4%% relative), but the flagship ``_given_extrema`` figure products then
inherit that error against the reference.  This module closes the gap with
a two-pass scheme that stays mergeable and memory-bounded:

* the 4096-bin log10 histogram (same binning as ``extrema_ops``) locates
  which bins contain the straddling order statistics of any requested
  percentile;
* EXACT sample values are retained only for a window of bins around the
  current target(s) -- a masked gather per file, typically a few percent
  of samples;
* if the pooled percentile later drifts outside the retained window
  (archives whose late files shift the distribution), the affected bins
  are re-gathered from the recorded file handles (the second pass), and
  the window recenters.

The returned value is bit-equal to
``float(np.nanpercentile(pool_float32, q))``: the order statistics are
exact, and both the virtual index and the interpolation mirror numpy's
float32 path (numpy matches the quantile dtype to the array dtype) --
verified against ``np.nanpercentile`` by brute-force randomized tests.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from configurable_spectrograms_torch.ops.extrema_ops import HIST_BINS, LOG_HI, LOG_LO, value_bins

#: Half-width (bins) of the retained-value window around each target bin.
#: 24 bins = 0.14 dex each side (~38%% in value), far wider than the
#: percentile of a growing pool typically moves between orbits.
DEFAULT_WINDOW = 24


#: The ONE definition of the binning lives in extrema_ops; ranks computed
#: from the histogram must always align with values gathered here.
_bins_for = value_bins


def _window_mask(values: np.ndarray, lo_bin: int, hi_bin: int) -> np.ndarray:
    """Cheap value-range preselection for bins [lo_bin, hi_bin] (inclusive).

    Selects by value bounds with a +/-1-bin safety margin (float32 log10 at
    a bin edge can land either side of the exact power-of-ten boundary),
    then the caller bins the small subset exactly.
    """
    step = (LOG_HI - LOG_LO) / HIST_BINS
    lo_edge = 10.0 ** (LOG_LO + (lo_bin - 1) * step) if lo_bin > 0 else 0.0
    hi_edge = 10.0 ** (LOG_LO + (hi_bin + 2) * step) if hi_bin < HIST_BINS - 1 else np.inf
    return (values >= lo_edge) & (values <= hi_edge)


def percentile_ranks(n: int, q: float) -> tuple[int, int, np.float32]:
    """The order-statistic ranks and gamma ``np.nanpercentile`` uses.

    For float32 pools numpy matches the quantile dtype to the ARRAY dtype,
    so the virtual index ``(n-1) * (q/100)`` and its fractional gamma are
    computed in float32 (verified by instrumenting ``numpy._lerp``) -- a
    float64 mirror picks the same ranks but drifts the interpolation by
    many float32 ulps.  Returns ``(k_lo, k_hi, gamma32)`` with the bound
    clamping numpy's ``_get_indexes`` applies.
    """
    # numpy's own expression (percentile/nanpercentile both divide by the
    # ARRAY dtype's 100): weak promotion casts the python-float q to
    # float32 BEFORE the division, so the float32 division rounds once --
    # `np.float32(q / 100.0)` (float64 divide, then cast) double-rounds
    # and drifts the virtual index for arbitrary q (fuzz: 66/4000
    # mismatches vs np.percentile; this form: 0/8000).  The q=1/99-style
    # presets coincide either way.
    q32 = np.true_divide(q, np.float32(100))
    vi = q32 * np.float32(n - 1)
    if vi >= n - 1:
        return n - 1, n - 1, np.float32(0.0)
    if vi < 0:
        return 0, 0, np.float32(0.0)
    prev = np.floor(vi)
    return int(prev), min(int(prev) + 1, n - 1), np.float32(vi - prev)


def numpy_lerp_percentile(v_lo: float, v_hi: float, gamma: np.float32) -> float:
    """numpy's ``_lerp`` between two float32 order statistics, float32 math.

    Branch for branch: ``a + diff*t`` below ``t >= 0.5``, ``b - diff*(1-t)``
    above, all in float32 (numpy matched gamma's dtype to the float32
    array), with the float32-rounded difference.

    Infinite order statistics (a pool holding ``inf``) make ``diff``
    NaN -- exactly as numpy's own ``_lerp`` does, and numpy then returns
    NaN for the percentile.  The arithmetic is kept identical for bit
    parity; only the RuntimeWarning is suppressed (``np.errstate``),
    since the NaN here is the CONTRACTED result, not an error.
    """
    with np.errstate(invalid="ignore"):
        a32 = np.float32(v_lo)
        b32 = np.float32(v_hi)
        t = np.float32(gamma)
        diff = np.float32(b32 - a32)
        if t >= np.float32(0.5):
            v = b32 - diff * (np.float32(1.0) - t)
        else:
            v = a32 + diff * t
        return float(np.float32(v))


def _normalize(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sort and merge overlapping/adjacent (lo, hi) bin intervals."""
    out: list[tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _gaps(span: tuple[int, int], covered: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The subintervals of *span* not covered by *covered* (normalized)."""
    lo, hi = span
    out = []
    pos = lo
    for clo, chi in covered:
        if chi < pos:
            continue
        if clo > hi:
            break
        if clo > pos:
            out.append((pos, min(clo - 1, hi)))
        pos = max(pos, chi + 1)
        if pos > hi:
            break
    if pos <= hi:
        out.append((pos, hi))
    return out


class ExactPercentileTracker:
    """Incrementally pooled samples answering exact ``np.nanpercentile``.

    ``add(values, regather)`` folds one file's positive collapsed samples
    into the pool: the full histogram is updated, values inside the
    current retention windows are kept exactly, and ``regather`` (a
    zero-argument callable returning the same values again, e.g. a file
    re-read) is recorded for the drift path.  ``percentile(q)`` then
    returns the exact pooled percentile.

    Retention is a SET of disjoint bin-interval windows, one per recently
    queried percentile target (capped at :data:`_MAX_WINDOWS`): querying
    both a high and a low percentile (``compute_mins``) keeps two small
    windows instead of retaining the entire inter-percentile span, and
    nothing is retained before the first query (the first query's
    re-gather populates exactly what it needs).
    """

    _MAX_WINDOWS = 4

    def __init__(self, window_bins: int = DEFAULT_WINDOW):
        self.window = int(window_bins)
        self.hist = np.zeros(HIST_BINS, np.int64)
        #: bin -> list of exact float32 value arrays
        self.retained: dict[int, list[np.ndarray]] = {}
        #: per file: [regather, normalized list of retained (lo, hi) intervals]
        self.files: list[list] = []
        #: retention windows applied to NEW files (disjoint, query-driven)
        self._windows: list[tuple[int, int]] = []
        #: re-gather passes performed (observability; tests assert on it)
        self.regathers = 0

    # -- ingest --------------------------------------------------------------

    def add(
        self,
        values: np.ndarray,
        regather: Callable[[], np.ndarray],
        hist: np.ndarray | None = None,
    ) -> None:
        """Fold one file's positive finite float32 samples into the pool.

        *hist* may pass the file's already-computed device histogram
        (``extrema_ops`` binning -- bit-identical to the host binning) to
        skip a host bincount.
        """
        values = np.asarray(values, np.float32)
        if hist is not None:
            self.hist += np.asarray(hist, np.int64)
        elif values.size:
            self.hist += np.bincount(_bins_for(values), minlength=HIST_BINS).astype(np.int64)
        for lo, hi in self._windows:
            self._retain(values, lo, hi)
        # Covered intervals must be NORMALIZED (sorted) -- _windows is kept
        # in recency order for LRU eviction, but _gaps assumes ascending
        # intervals and would misread coverage (double-retaining bins and
        # tripping the count-consistency check).
        self.files.append([regather, _normalize(self._windows)])

    def _retain(self, values: np.ndarray, lo: int, hi: int) -> None:
        if not values.size:
            return
        sub = values[_window_mask(values, lo, hi)]
        if not sub.size:
            return
        bins = _bins_for(sub)
        keep = (bins >= lo) & (bins <= hi)
        sub, bins = sub[keep], bins[keep]
        for b in np.unique(bins):
            self.retained.setdefault(int(b), []).append(sub[bins == b])

    # -- queries -------------------------------------------------------------

    def _bin_of_rank(self, rank: int, cum: np.ndarray) -> int:
        return int(min(np.searchsorted(cum, rank + 1, side="left"), HIST_BINS - 1))

    def _note_window(self, lo: int, hi: int) -> None:
        """Adopt (lo, hi) as a retention window for future files.

        Overlapping windows merge INTO the new window, which always goes
        to the recent end of the list; beyond the cap the LEAST RECENTLY
        QUERIED window is dropped (future files stop retaining it --
        already-retained values stay, and a later query there re-gathers).
        The list is kept in recency order, NOT bin order: sorting before
        eviction would evict by bin position and could drop the window
        just adopted for the current query."""
        keep = []
        for w in self._windows:
            if w[0] <= hi + 1 and lo <= w[1] + 1:  # overlap/adjacent: absorb
                lo, hi = min(lo, w[0]), max(hi, w[1])
            else:
                keep.append(w)
        keep.append((lo, hi))
        while len(keep) > self._MAX_WINDOWS:
            keep.pop(0)
        self._windows = keep

    def _ensure_bins(self, need: tuple[int, int], fetch: tuple[int, int]) -> None:
        """Guarantee exact values exist for the *need* bins from every file.

        Files whose retained intervals miss part of *need* are re-read (the
        drift second pass) and the wider *fetch* window is gathered so the
        next nearby query doesn't re-read them again.
        """
        hit_any = False
        for entry in self.files:
            regather, covered = entry
            if not _gaps(need, covered):
                continue
            hit_any = True
            values = np.asarray(regather(), np.float32)
            for seg in _gaps(fetch, covered):
                self._retain(values, *seg)
            entry[1] = _normalize(covered + [fetch])
        if hit_any:
            self.regathers += 1

    def _order_stat(self, rank: int, cum: np.ndarray) -> float:
        b = self._bin_of_rank(rank, cum)
        before = int(cum[b - 1]) if b > 0 else 0
        vals = np.sort(np.concatenate(self.retained.get(b, [np.empty(0, np.float32)])))
        if len(vals) != int(self.hist[b]):
            raise AssertionError(
                f"retained bin {b} holds {len(vals)} values but the histogram "
                f"counts {int(self.hist[b])} -- binning drift or missed re-gather"
            )
        return float(vals[rank - before])

    def percentile(self, q: float) -> float:
        """Exact ``float(np.nanpercentile(pool, q))``; 0.0 on an empty pool."""
        n = int(self.hist.sum())
        if n == 0:
            return 0.0
        k_lo, k_hi, gamma = percentile_ranks(n, q)
        cum = np.cumsum(self.hist)
        b_lo = self._bin_of_rank(k_lo, cum)
        b_hi = self._bin_of_rank(k_hi, cum)
        fetch = (max(0, b_lo - self.window), min(HIST_BINS - 1, b_hi + self.window))
        self._note_window(*fetch)
        self._ensure_bins((b_lo, b_hi), fetch)
        v_lo = self._order_stat(k_lo, cum)
        v_hi = v_lo if k_hi == k_lo else self._order_stat(k_hi, cum)
        return numpy_lerp_percentile(v_lo, v_hi, gamma)
