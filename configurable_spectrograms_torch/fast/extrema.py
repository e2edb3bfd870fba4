"""Global axis-extrema computation for FAST batch plotting.

:func:`compute_global_extrema` performs a resumable pass over instrument
CDF files to determine shared axis limits before the main plotting pass,
with the exact JSON cache contract of the reference
(reference fast/extrema.py:73-366): value keys
``{inst}_{y}_{z}_{y|z}_{min|max}``, per-instrument
``{...}_extrema_progress`` entries, a ``{y}_{z}_last_orbit`` resume cursor
ordered first in the file, linear_linear reuse with log transform, monotone
non-decreasing maxima, the 4000 energy cap, and batched flushing.

Port of the JAX package's ``fast/extrema.py``: the same JSON cache
contract and update math, with the per-file statistics of each chunk of
orbits computed by one launch of the collapse kernel
(:mod:`configurable_spectrograms_torch.ops.extrema_ops`).  Pooled-percentile
z-maxima are EXACT by default -- bit-equal to the reference's
``np.nanpercentile`` over the whole pool (reference fast/extrema.py:280-285)
via the windowed two-pass tracker in
:mod:`configurable_spectrograms_torch.ops.exact_percentile`, which retains
only samples near the percentile and re-gathers from files when the target
drifts.  ``CST_EXTREMA_EXACT=0`` (or ``exact_percentile=False``) switches
to the pure log-histogram estimate (bounded <1.4%% relative error, then
ceil'd as the reference does), which skips the host collapse entirely and
is the cheaper choice when reference-exact bounds don't matter.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any

import numpy as np

from configurable_spectrograms_torch.data.cdf_utils import load_fast_cdf_dataset
from configurable_spectrograms_torch.data.orbit_discovery import discover_orbit_files
from configurable_spectrograms_torch.fast.constants import FAST_EXTREMA_JSON_PATH
from configurable_spectrograms_torch.ops.exact_percentile import ExactPercentileTracker
from configurable_spectrograms_torch.ops.extrema_ops import HIST_BINS, batched_file_stats, hist_percentile
from configurable_spectrograms_torch.utils.logging import log_exception
from configurable_spectrograms_torch.utils.percentiles import round_extrema
from configurable_spectrograms_torch.utils.progress import atomic_write_json, tqdm_or_none
from configurable_spectrograms_torch.utils.timing import active_stage


def extrema_overrides(
    global_extrema: dict | None,
    inst: str,
    y_scale: str,
    z_scale: str,
) -> tuple[float | None, float | None, float | None, float | None]:
    """Extract and round per-instrument axis limits from an extrema dict.

    Parity with reference fast/extrema.py:26-70.

    Examples
    --------
    >>> extrema = {"ees_linear_linear_y_max": 1234, "ees_linear_linear_z_min": 0.0123}
    >>> extrema_overrides(extrema, "ees", "linear", "linear")
    (None, 1300.0, 0.012, None)
    >>> extrema_overrides(None, "ees", "linear", "linear")
    (None, None, None, None)
    """
    if not isinstance(global_extrema, dict):
        return None, None, None, None
    key_prefix = f"{inst}_{y_scale}_{z_scale}"

    def _rounded(value: float | None, direction: str) -> float | None:
        return round_extrema(value, direction) if value is not None else None

    return (
        _rounded(global_extrema.get(f"{key_prefix}_y_min"), "down"),
        _rounded(global_extrema.get(f"{key_prefix}_y_max"), "up"),
        _rounded(global_extrema.get(f"{key_prefix}_z_min"), "down"),
        _rounded(global_extrema.get(f"{key_prefix}_z_max"), "up"),
    )


def load_reference_extrema(path: str) -> dict[str, Any]:
    """Read an extrema cache JSON, whichever package wrote it.

    Both packages write the same keys (``{inst}_{y}_{z}_{y|z}_{min|max}``,
    the ``_extrema_progress`` entries and the ``{y}_{z}_last_orbit``
    cursor), so a file from the JAX package drives this package's
    given-extrema render as it is, and the reverse.
    """
    with open(path) as f:
        return json.load(f)


def _ordered_with_cursor_first(state: dict[str, Any], cursor_key: str) -> dict[str, Any]:
    if cursor_key not in state:
        return state
    ordered = {cursor_key: state[cursor_key]}
    ordered.update({k: v for k, v in state.items() if k != cursor_key})
    return ordered


def compute_global_extrema(
    directory_path: str,
    y_scale: str,
    z_scale: str,
    instrument_order,
    extrema_json_path: str = FAST_EXTREMA_JSON_PATH,
    compute_mins: bool = False,
    max_percentile: float = 95.0,
    log_floor_cutoff: float = 0.1,
    log_floor_value: float = -1.0,
    flush_batch_size: int = 10,
    exact_percentile: bool | None = None,
) -> dict[str, Any]:
    """Compute (or incrementally update) cached axis extrema per instrument.

    Extrema logic (identical to the reference's, fast/extrema.py:92-120):
    y minima fixed to 0 unless ``compute_mins``; linear y maxima = smallest
    energy reaching 99%% cumulative positive coverage; linear z maxima =
    ``max_percentile`` of pooled positive samples; log scales derive from
    cached linear_linear values via log10 with the
    ``log_floor_cutoff``/``log_floor_value`` floor; maxima are monotone
    non-decreasing across incremental updates and energy is capped at 4000;
    everything is ceil'd.  Progress flushes to ``extrema_json_path`` every
    ``flush_batch_size`` orbits with a final guaranteed flush.

    ``exact_percentile`` (default: ``CST_EXTREMA_EXACT`` env, on) makes the
    pooled z percentiles bit-equal to the reference's ``np.nanpercentile``;
    off uses the histogram upper-edge estimate.
    """
    if exact_percentile is None:
        exact_percentile = os.environ.get("CST_EXTREMA_EXACT", "1") != "0"
    instrument_order = tuple(instrument_order)
    flush_batch_size = max(1, int(flush_batch_size))
    state: dict[str, Any] = {}
    if os.path.exists(extrema_json_path):
        try:
            with open(extrema_json_path) as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            log_exception(
                f"[EXTREMA] Failed to read existing extrema JSON '{extrema_json_path}' (starting fresh)",
                exc,
                level="message",
            )
            state = {}

    def _safe_log(value) -> float:
        if value is None:
            return float(log_floor_value)
        try:
            v = float(value)
        except (TypeError, ValueError):
            return float(log_floor_value)
        if not np.isfinite(v) or v <= log_floor_cutoff:
            return float(log_floor_value)
        return float(np.log10(v))

    def _flush(force: bool = False) -> None:
        try:
            atomic_write_json(extrema_json_path, _ordered_with_cursor_first(state, cursor_key))
        except OSError as exc:
            log_exception("[EXTREMA] Failed to save extrema JSON", exc, level="message")

    orbit_map = discover_orbit_files(directory_path, instrument_order)
    sorted_orbits = sorted(orbit_map.keys())
    totals = {
        inst: sum(1 for o in sorted_orbits if inst in orbit_map[o]) for inst in instrument_order
    }

    cursor_key = f"{y_scale}_{z_scale}_last_orbit"
    last_val = state.get(cursor_key, -1)
    last_orbit = int(last_val) if isinstance(last_val, (int, float)) else -1

    # --- linear_linear reuse: copy or log-transform without rescanning -----
    active_insts = []
    for inst in instrument_order:
        key_prefix = f"{inst}_{y_scale}_{z_scale}"
        progress_key = f"{key_prefix}_extrema_progress"
        entry = state.get(progress_key)
        if isinstance(entry, dict) and entry.get("complete"):
            continue
        ll_y = f"{inst}_linear_linear_y_max"
        ll_z = f"{inst}_linear_linear_z_max"
        if y_scale != "log" and ll_y in state:
            state[f"{key_prefix}_y_max"] = state[ll_y]
            state[f"{key_prefix}_y_min"] = state.get(f"{inst}_linear_linear_y_min", 0)
        elif y_scale == "log" and ll_y in state:
            state[f"{key_prefix}_y_max"] = _safe_log(state[ll_y])
            state[f"{key_prefix}_y_min"] = log_floor_value
        if z_scale != "log" and ll_z in state:
            state[f"{key_prefix}_z_max"] = state[ll_z]
            state[f"{key_prefix}_z_min"] = state.get(f"{inst}_linear_linear_z_min", 0)
        elif z_scale == "log" and ll_z in state:
            state[f"{key_prefix}_z_max"] = _safe_log(state[ll_z])
            state[f"{key_prefix}_z_min"] = log_floor_value
        if ll_y in state and ll_z in state:
            state[progress_key] = {
                "processed_index": max(totals[inst] - 1, -1),
                "total": totals[inst],
                "complete": True,
            }
            state[cursor_key] = max(sorted_orbits) if sorted_orbits else -1
            _flush(force=True)
            continue
        active_insts.append(inst)

    if not active_insts:
        return _ordered_with_cursor_first(state, cursor_key)

    # --- incremental scan (device-reduced, chunked across orbits) -----------
    energy_counts: dict[str, dict[float, int]] = {inst: {} for inst in active_insts}
    hists: dict[str, np.ndarray] = {inst: np.zeros(HIST_BINS, np.int64) for inst in active_insts}
    trackers: dict[str, ExactPercentileTracker] = (
        {inst: ExactPercentileTracker() for inst in active_insts} if exact_percentile else {}
    )
    orbits_since_flush = 0

    from configurable_spectrograms_torch.ops.extrema_ops import collapsed_positives

    def _regather_from(path: str):
        def regather() -> np.ndarray:
            ds = load_fast_cdf_dataset(path)
            return collapsed_positives(ds["data"].astype(np.float32, copy=False))

        return regather

    pending_indexed = [(i, o) for i, o in enumerate(sorted_orbits) if o > last_orbit]
    tqdm = tqdm_or_none()
    bar = None if tqdm is None else tqdm(total=len(pending_indexed), desc=f"Extrema {y_scale}/{z_scale}",
                                         unit="orbit", leave=False, disable=(len(pending_indexed) == 0))

    # Orbits per device launch: two files' worth on the one device, capped
    # by the flush cadence so resume granularity is unchanged.
    chunk_orbits = min(max(1, -(-2 // max(1, len(active_insts)))), flush_batch_size)

    def _update_state_for_orbit(orbit_index: int, orbit: int) -> None:
        """Derive and store the post-orbit extrema for every active instrument
        (identical math to the reference's per-orbit update,
        reference fast/extrema.py:245-322)."""
        for inst in active_insts:
            key_prefix = f"{inst}_{y_scale}_{z_scale}"
            try:
                counts_map = energy_counts[inst]
                candidate_e = 0.0
                if counts_map:
                    es = sorted(counts_map)
                    cum = np.cumsum([counts_map[e] for e in es])
                    target = 0.99 * cum[-1]
                    idx = min(int(np.searchsorted(cum, target, side="right")), len(es) - 1)
                    candidate_e = float(es[idx])
                if exact_percentile:
                    try:
                        with active_stage("prepass_tracker"):
                            candidate_z = trackers[inst].percentile(max_percentile)
                    except Exception as exc:
                        log_exception(
                            f"[EXTREMA] exact percentile failed inst={inst} orbit={orbit}; "
                            "falling back to the histogram estimate",
                            exc,
                            level="message",
                        )
                        candidate_z = hist_percentile(hists[inst], max_percentile)
                else:
                    candidate_z = hist_percentile(hists[inst], max_percentile)

                prev_e = state.get(f"{key_prefix}_y_max")
                prev_z = state.get(f"{key_prefix}_z_max")
                merged_e = max(float(prev_e), candidate_e) if isinstance(prev_e, (int, float)) else candidate_e
                merged_z = max(float(prev_z), candidate_z) if isinstance(prev_z, (int, float)) else candidate_z
                merged_e = int(min(4000, math.ceil(merged_e)))
                merged_z = float(math.ceil(merged_z))

                if compute_mins and hists[inst].sum() > 0:
                    if exact_percentile:
                        try:
                            with active_stage("prepass_tracker"):
                                z_min_store = trackers[inst].percentile(1.0)
                        except Exception:
                            z_min_store = hist_percentile(hists[inst], 1.0)
                    else:
                        z_min_store = hist_percentile(hists[inst], 1.0)
                else:
                    z_min_store = 0
                state[f"{key_prefix}_y_min"] = 0
                state[f"{key_prefix}_y_max"] = merged_e
                state[f"{key_prefix}_z_min"] = z_min_store
                state[f"{key_prefix}_z_max"] = merged_z
                state[f"{key_prefix}_extrema_progress"] = {
                    "processed_index": orbit_index,
                    "total": totals[inst],
                    "complete": orbit_index + 1 >= totals[inst],
                }
                state[cursor_key] = orbit
            except Exception as exc:
                log_exception(
                    f"[EXTREMA] Update failure inst={inst} orbit={orbit}",
                    exc,
                    level="message",
                )

    try:
        for c0 in range(0, len(pending_indexed), chunk_orbits):
            chunk = pending_indexed[c0 : c0 + chunk_orbits]
            # Load every active instrument's file for the chunk's orbits and
            # reduce them in ONE device launch.
            loaded: list[tuple[int, str, np.ndarray, np.ndarray]] = []
            for _, orbit in chunk:
                for inst in active_insts:
                    path = orbit_map.get(orbit, {}).get(inst)
                    if path is None:
                        continue
                    try:
                        ds = load_fast_cdf_dataset(path)
                        loaded.append(
                            (orbit, inst, ds["data"].astype(np.float32, copy=False), ds["energy"], path)
                        )
                    except Exception as exc:
                        log_exception(
                            f"[EXTREMA] Ingest failure inst={inst} orbit={orbit} file={path}",
                            exc,
                            level="message",
                        )
            with active_stage("prepass_stats"):
                stats = batched_file_stats([cube for _, _, cube, _, _ in loaded])
            stats_by_orbit: dict[int, list] = {}
            for (orbit, inst, cube, energy, path), st in zip(loaded, stats):
                stats_by_orbit.setdefault(orbit, []).append((inst, energy, st, cube, path))

            # Fold chunk results orbit by orbit IN ORDER so the monotone
            # merge and cursor semantics match the sequential scan exactly.
            for orbit_index, orbit in chunk:
                for inst, energy, st, cube, path in stats_by_orbit.get(orbit, []):
                    counts_map = energy_counts[inst]
                    for e_val, cnt in zip(energy, st["counts"]):
                        if cnt:
                            counts_map[float(e_val)] = counts_map.get(float(e_val), 0) + int(cnt)
                    hists[inst] += st["hist"].astype(np.int64)
                    if exact_percentile:
                        # Added INSIDE the per-orbit fold: the reference's
                        # candidate at orbit i is the percentile of the pool
                        # up to orbit i, and the monotone max over prefixes
                        # depends on those exact prefixes.  The tracker is
                        # fully host-consistent (host collapse + binning):
                        # on-silicon log10 can differ from the host by an
                        # ulp at a bin edge, and mixing the device histogram
                        # with host-gathered values would trip the tracker's
                        # count consistency check.
                        with active_stage("prepass_host_collapse"):
                            positives = collapsed_positives(cube)
                        with active_stage("prepass_tracker"):
                            trackers[inst].add(positives, _regather_from(path))
                _update_state_for_orbit(orbit_index, orbit)
                if bar is not None:
                    bar.update(1)
                orbits_since_flush += 1
            if orbits_since_flush >= flush_batch_size:
                _flush(force=True)
                orbits_since_flush = 0

        if orbits_since_flush > 0:
            _flush(force=True)
    finally:
        if bar is not None:
            bar.close()

    return _ordered_with_cursor_first(state, cursor_key)
