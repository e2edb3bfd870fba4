"""CDF file metadata, cusp-CSV lookup, and FAST dataset loading.

A copy of the JAX package's ``data/cdf_utils.py`` (file-type detection,
orbit-boundary lookup, the variable shape survey and the cached dataset
decode).  ``pandas`` is imported only where the cusp CSV is read, and
``tqdm`` only where the survey draws its optional progress bar.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import numpy as np

from configurable_spectrograms_torch.constants import (
    CDF_DATA_DIRECTORY,
    CDF_VARIABLE_NAMES,
    FILTERED_ORBITS_CSV_PATH,
)
from configurable_spectrograms_torch.data.cdf import CDF
from configurable_spectrograms_torch.utils.logging import log_error, log_message
from configurable_spectrograms_torch.utils.timing import active_stage

#: Recognized filename tags.  ``esv`` extends the reference's set (its
#: download.py:22 notes esv CDFs exist but never recognizes them); the
#: default batch instrument order stays the reference's four, so esv only
#: participates when a caller asks for it via ``instrument_order``.
INSTRUMENT_TAGS = ("ees", "eeb", "ies", "ieb", "esv")

# Module-level caches avoiding repeated disk I/O in batch loops.
filtered_orbits_cache: dict[str, "pd.DataFrame | None"] = {}
orbit_column_cache: dict[tuple[tuple[str, ...], str], tuple[str, str, str]] = {}
cdf_type_cache: dict[str, str | None] = {}
_dataset_cache: dict[tuple, dict[str, np.ndarray]] = {}
#: All _dataset_cache access (lookup, insert, eviction, byte accounting)
#: happens under this lock: the batch driver's ThreadPoolExecutor workers
#: call load_fast_cdf_dataset concurrently, and unguarded eviction while
#: another thread inserts raises mid-batch (marking the orbit as a
#: permanent error in the progress JSON).
_dataset_cache_lock = threading.Lock()
_dataset_cache_bytes = 0  # running total; maintained under the lock
#: Single-flight registry: cache_key -> Event set by the thread decoding
#: that file; concurrent missers wait instead of duplicating the decode.
_dataset_inflight: dict[tuple, threading.Event] = {}
#: Observability counters (maintained under the lock); read via
#: :func:`dataset_cache_stats`, reset by tests.
_dataset_cache_stats = {"hits": 0, "misses": 0, "waits": 0}


def dataset_cache_stats() -> dict[str, int]:
    """A snapshot of the dataset cache's hit/miss/single-flight-wait counts."""
    with _dataset_cache_lock:
        return dict(_dataset_cache_stats)


def clear_dataset_cache() -> None:
    """Drop every cached dataset (a timed run can then start cold)."""
    global _dataset_cache_bytes
    with _dataset_cache_lock:
        _dataset_cache.clear()
        _dataset_cache_bytes = 0
#: Byte budget for cached datasets (FIFO eviction).  A dataset costs about
#: its cube: 268 MB for the instrument's 8192x64x128 float32 cube (12.6 MB
#: for the 2048x32x48 bench cube), so 1.5 GB holds about 5 real cubes.
#: The batch driver's 4 workers x 4 instruments may want 16 at once, and
#: the orbit-major schedule's working set of 1-2 orbits is 4-8 of them: at
#: the real size the cache thrashes where the workers straddle two orbits.
#: The device cube cache (render/device_cache.py) keys its padded copies
#: on the host cube and drops one when that cube dies, so a dataset this
#: cache evicts takes its device copy with it, and the device budget (a
#: quarter of the card) is bounded in practice by this one; a cube decoded
#: again is uploaded again.  Measured over 12 and 20 real orbits on one
#: H100 (``chip_smoke.py --scale-orbits 12 --scale-shape 8192x64x128``):
#: 3.06-3.27 decodes per file and 1.93-1.96 uploads per cube over a killed
#: and a resumed run (the extrema pre-pass's one of each included), no
#: eviction by the device budget, and 3.8 GB allocated on the card at most.
_DATASET_CACHE_MAX_BYTES = int(os.environ.get("CST_DATASET_CACHE_BYTES", 1_500_000_000))


#: The cusp-event index shipped at the repository root (the reference's
#: real 2000-2001 dataset, reference FAST_Cusp_Indices.csv:1).  Used as a
#: fallback when the CWD-relative default path has no copy, so the shipped
#: data works from any working directory.
_SHIPPED_CUSP_CSV = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "FAST_Cusp_Indices.csv",
)


def load_filtered_orbits(csv_path: str = FILTERED_ORBITS_CSV_PATH) -> pd.DataFrame | None:
    """Cached load of the cusp-orbit index (tab-separated despite ``.csv``).

    The default (CWD-relative, reference constants.py:28) is overridable
    with ``CST_CUSP_CSV`` (the CLIs take no cusp-file flag, matching the
    reference) and falls back to the repo-shipped dataset when absent.
    Returns ``None`` (after logging) when the file can't be read, so
    callers degrade to marker-free plots.
    """
    import pandas as pd

    if csv_path == FILTERED_ORBITS_CSV_PATH:
        csv_path = os.environ.get("CST_CUSP_CSV") or csv_path
    if csv_path not in filtered_orbits_cache:
        # ParserError subclasses ValueError, so (OSError, ValueError) covers
        # missing, unreadable, and malformed files alike.  The shipped
        # dataset substitutes only when the default-path file is *absent*;
        # a present-but-unreadable user file must degrade to marker-free
        # plots with a log line, never silently swap datasets.
        try:
            filtered_orbits_cache[csv_path] = pd.read_csv(csv_path, sep="\t")
        except (OSError, ValueError) as exc:
            absent = isinstance(exc, FileNotFoundError)
            if absent and csv_path == FILTERED_ORBITS_CSV_PATH and os.path.exists(_SHIPPED_CUSP_CSV):
                try:
                    filtered_orbits_cache[csv_path] = pd.read_csv(_SHIPPED_CUSP_CSV, sep="\t")
                except (OSError, ValueError) as exc2:
                    log_error(f"Error loading CSV {_SHIPPED_CUSP_CSV}: {exc2}")
                    return None
            else:
                log_error(f"Error loading CSV {csv_path}: {exc}")
                return None
    return filtered_orbits_cache[csv_path]


def _orbit_columns(dataframe: pd.DataFrame, instrument: str) -> tuple[str, str, str]:
    """Resolve (orbit, min-index, max-index) column names, cached per schema.

    Keyed by the column tuple, not ``id(dataframe)``: ids are reused after
    garbage collection, so an id key can serve a dead frame's column names
    to a fresh frame with a different schema.
    """
    cache_key = (tuple(dataframe.columns), instrument)
    if cache_key not in orbit_column_cache:
        cols = list(dataframe.columns)
        orbit_col = next(c for c in cols if "orbit" in c.lower())
        min_col = next(c for c in cols if instrument in c.lower() and "min index" in c.lower())
        max_col = next(c for c in cols if instrument in c.lower() and "max index" in c.lower())
        orbit_column_cache[cache_key] = (orbit_col, min_col, max_col)
    return orbit_column_cache[cache_key]


#: orbit -> (raw_min, raw_max) lookup per (live dataframe, column triple).
#: A batch calls :func:`get_timestamps_for_orbit` once per figure (8+
#: times per orbit across combos and raw/given passes) against the same
#: module-cached cusp dataframe; the pandas boolean scan + iloc row it
#: replaces cost ~3 ms per call.  Keyed by ``id(dataframe)`` with a
#: weakref finalizer evicting on the frame's death, so a recycled id can
#: never serve a dead frame's rows (same discipline as the resident
#: quantize caches, render/host_quantize.py).
_orbit_row_cache: dict[tuple[int, tuple[str, str, str]], tuple[bytes | None, dict]] = {}


def _column_fingerprint(orbits, lows, highs) -> bytes | None:
    """Raw bytes of the three relevant columns, ``None`` when unhashable.

    Recomputed on every cache hit (~µs for the 325-row cusp frame) so an
    in-place mutation of the columns this function reads is always seen
    -- the cached map replaces a ~3 ms pandas scan, not the reference's
    re-read semantics.  Mutations to *other* columns don't change the
    output and legitimately keep the hit.

    Object-dtype columns report ``None`` explicitly: their ``tobytes()``
    does NOT raise -- it returns raw PyObject pointer bytes, under which
    an in-place mutation of a cell (same pointer, new contents) would
    yield a stale hit and a freed/reallocated object could alias a dead
    pointer (ADVICE r4).
    """
    if any(getattr(a, "dtype", None) == object for a in (orbits, lows, highs)):
        return None  # pointer bytes are not a stable content view
    try:
        return orbits.tobytes() + lows.tobytes() + highs.tobytes()
    except (TypeError, AttributeError):
        return None  # no stable byte view


def _orbit_row_map(dataframe: pd.DataFrame, cols: tuple[str, str, str]) -> dict:
    import weakref

    orbit_col, min_col, max_col = cols
    orbits = dataframe[orbit_col].to_numpy()
    lows = dataframe[min_col].to_numpy()
    highs = dataframe[max_col].to_numpy()
    fp = _column_fingerprint(orbits, lows, highs)
    key = (id(dataframe), cols)
    hit = _orbit_row_cache.get(key)
    if hit is not None and fp is not None and hit[0] == fp:
        return hit[1]
    mapping: dict = {}
    for i in range(len(orbits)):
        ov = orbits[i]
        if ov not in mapping:  # first match wins, like .iloc[0]
            mapping[ov] = (lows[i], highs[i])
    if fp is None:
        return mapping  # unfingerprintable: serve without caching
    if key not in _orbit_row_cache:
        # Register the death-eviction finalizer only on first insert: a
        # frame mutated between calls rebuilds the mapping many times, and
        # one finalizer per rebuild would accumulate for the frame's
        # lifetime (ADVICE r4) -- the pop-by-key is idempotent either way.
        try:
            weakref.finalize(dataframe, _orbit_row_cache.pop, key, None)
        except TypeError:
            return mapping  # not weakref-able: serve without caching
    _orbit_row_cache[key] = (fp, mapping)
    return mapping


def get_timestamps_for_orbit(
    filtered_orbits_dataframe: pd.DataFrame | None,
    orbit_number: int,
    instrument_type: str | None,
    time_unix_array: np.ndarray | None,
) -> list[float]:
    """Orbit-boundary UNIX timestamps from the cusp index's min/max rows.

    Indices clamp into the time array; a degenerate (equal) pair yields a
    single timestamp; an unknown orbit or missing inputs yield ``[]``
    (reference cdf_utils.py:55-123).

    Examples
    --------
    >>> import pandas as pd
    >>> import numpy as np
    >>> idx = pd.DataFrame({"orbit": [7], "ies min index": [0], "ies Max index": [2]})
    >>> get_timestamps_for_orbit(idx, 7, "ies", np.array([5.0, 6.0, 7.0]))
    [5.0, 7.0]
    >>> get_timestamps_for_orbit(idx, 8, "ies", np.array([5.0, 6.0, 7.0]))
    []
    """
    if filtered_orbits_dataframe is None or instrument_type is None or time_unix_array is None:
        return []
    cols = _orbit_columns(filtered_orbits_dataframe, instrument_type)
    # dict lookup == the reference's boolean-mask + .iloc[0] row pick:
    # first row wins on duplicate orbits, numeric keys hash-compatibly
    # across int/np.int64/float, and a missing orbit yields [].  The
    # cached map revalidates against the columns' bytes on every call,
    # so in-place mutation of the frame is honored like the reference's
    # per-call scan.
    row = _orbit_row_map(filtered_orbits_dataframe, cols).get(orbit_number)
    if row is None:
        return []
    try:
        raw_lo = int(row[0])
        raw_hi = int(row[1])
    except (TypeError, ValueError):
        log_message("[WARN] Non-integer indices found in orbit row, using 0.")
        return []
    top = len(time_unix_array) - 1
    lo = min(max(raw_lo, 0), top)
    hi = min(max(raw_hi, 0), top)
    if lo == hi:
        return [float(time_unix_array[lo])]
    return [float(time_unix_array[lo]), float(time_unix_array[hi])]


def get_cdf_file_type(cdf_file_path: str) -> str | None:
    """Instrument tag parsed from a CDF path (``'orb'`` for ephemeris files).

    Examples
    --------
    >>> get_cdf_file_type("fa_esa_l2_eeb_20000101001737_13312_v02.cdf")
    'eeb'
    >>> get_cdf_file_type("fa_k0_orb_13312_v01.cdf")
    'orb'
    """
    lowered = cdf_file_path.lower()
    if "_orb_" in lowered:
        return "orb"
    tag = next((t for t in INSTRUMENT_TAGS if f"_{t}_" in lowered), None)
    if tag is None:
        log_error(f"Unknown CDF file type for path: {cdf_file_path}")
    return tag


def get_variable_shape(cdf_path: str, variable_name: str) -> tuple[int, ...] | None:
    """Shape of one variable in one CDF (``None`` for orb files or errors)."""
    if cdf_path not in cdf_type_cache:
        cdf_type_cache[cdf_path] = get_cdf_file_type(cdf_path)
    if cdf_type_cache[cdf_path] in (None, "orb"):
        return None
    try:
        with CDF(cdf_path) as cdf:
            data = cdf.varget(variable_name)
    except Exception as exc:
        log_error(f"Error reading {cdf_path} for variable {variable_name}: {exc}")
        return None
    return data.shape if isinstance(data, np.ndarray) else None


def get_cdf_var_shapes(
    cdf_folder_path: str = CDF_DATA_DIRECTORY,
    variable_names: list[str] = CDF_VARIABLE_NAMES,
) -> dict[str, list[tuple[int, ...] | None]]:
    """Survey variable shapes across every CDF under a folder."""
    from configurable_spectrograms_torch.utils.progress import tqdm_or_none

    tqdm = tqdm_or_none()
    paths = [str(p) for p in Path(cdf_folder_path).rglob("*.[cC][dD][fF]")]

    def walk(name: str) -> list[str]:
        if tqdm is None:
            return paths
        return tqdm(paths, desc=f"Processing CDF files ({name})", unit="file", total=len(paths))

    return {name: [get_variable_shape(p, name) for p in walk(name)] for name in variable_names}


def load_fast_cdf_dataset(
    cdf_path: str, variable_names: tuple[str, ...] = tuple(CDF_VARIABLE_NAMES)
) -> dict[str, np.ndarray]:
    """Load one FAST instrument file into analysis-ready arrays.

    ``energy``/``pitch_angle`` collapse from their broadcast 3D storage to
    1D bin arrays, and ``data`` lands in ``(time, pitch_angle, energy)``
    order regardless of whether the file stored ``(time, energy, pitch)``
    (reference cdf_utils.py:222-256).

    A small (path, mtime)-keyed cache serves repeat reads -- the per-orbit
    worker touches each file three times (reference
    fast/process_orbit.py:148-253) -- and the shared contiguous float32
    cube lets the device batcher upload one copy per file.  Loads are
    single-flight: when several batch workers miss on the same file at
    once (an orbit's raw and given-extrema jobs run concurrently), one
    thread decodes and the rest wait for its result instead of all paying
    the ~40 ms decode.  Treat the returned arrays as read-only.
    """
    try:
        mtime = os.path.getmtime(cdf_path)
    except OSError:
        mtime = None
    cache_key = (cdf_path, mtime, tuple(variable_names))
    my_event = None
    try:
        if mtime is not None:
            while True:
                with _dataset_cache_lock:
                    cached = _dataset_cache.get(cache_key)
                    if cached is not None:
                        _dataset_cache_stats["hits"] += 1
                        return cached
                    other = _dataset_inflight.get(cache_key)
                    if other is None:
                        # Registration happens inside this function's
                        # try so the finally below unregisters + wakes on
                        # EVERY exit -- including an async
                        # KeyboardInterrupt or MemoryError raised before
                        # the decode even starts -- or the stale
                        # never-set Event would make every future load of
                        # this file block forever in event.wait().
                        my_event = threading.Event()
                        _dataset_inflight[cache_key] = my_event
                        _dataset_cache_stats["misses"] += 1
                        break  # this thread is the loader
                    _dataset_cache_stats["waits"] += 1
                other.wait()
                shared = getattr(other, "result", None)
                if shared is not None:
                    return shared
                # The loader failed (its exception propagates on its own
                # thread); loop back so one waiter becomes the new loader.

        with active_stage("cdf_decode"):
            result = _decode_fast_cdf(cdf_path, variable_names)
        if my_event is None:
            return result  # mtime unavailable: uncacheable, no waiters
        my_event.result = result  # waiters get the arrays even when uncacheable
        entry_bytes = sum(a.nbytes for a in result.values())
        global _dataset_cache_bytes
        with _dataset_cache_lock:
            # Eligibility first: an entry that cannot be inserted anyway
            # (oversized, or a racing thread already cached it) must not
            # evict everyone else's resident datasets trying to make room.
            if entry_bytes <= _DATASET_CACHE_MAX_BYTES and cache_key not in _dataset_cache:
                while _dataset_cache and _dataset_cache_bytes + entry_bytes > _DATASET_CACHE_MAX_BYTES:
                    evicted = _dataset_cache.pop(next(iter(_dataset_cache)))
                    _dataset_cache_bytes -= sum(a.nbytes for a in evicted.values())
                _dataset_cache[cache_key] = result
                _dataset_cache_bytes += entry_bytes
        return result
    finally:
        if my_event is not None:
            try:
                with _dataset_cache_lock:
                    _dataset_inflight.pop(cache_key, None)
            finally:
                # set() runs even if an async exception lands during the
                # pop, so waiters already parked on the popped event
                # still wake (and retry as loaders on a None result).
                my_event.set()


def _decode_fast_cdf(cdf_path: str, variable_names: tuple[str, ...]) -> dict[str, np.ndarray]:
    """The uncached decode: CDF records -> analysis-ready float32 arrays."""
    t_name, d_name, e_name, p_name = variable_names
    with CDF(cdf_path) as handle:
        times = np.asarray(handle.varget(t_name))
        data = np.asarray(handle.varget(d_name))
        energy_raw = np.asarray(handle.varget(e_name))
        pitch_raw = np.asarray(handle.varget(p_name))
    # Copies, not views: a view of the (T, A, E) broadcast variable keeps the whole of it alive in the
    # dataset cache, which counts the view's bytes only (an 8192x64x128 file's entry held 805 MB, not 268).
    energy = energy_raw[0, 0, :].copy() if energy_raw.ndim == 3 else energy_raw
    pitch_angle = pitch_raw[0, :, 0].copy() if pitch_raw.ndim == 3 else pitch_raw
    if data.shape[1] == len(energy) and data.shape[2] == len(pitch_angle):
        data = np.transpose(data, (0, 2, 1))
    return {
        "times": times,
        "data": np.ascontiguousarray(data, dtype=np.float32),
        "energy": energy,
        "pitch_angle": pitch_angle,
    }
