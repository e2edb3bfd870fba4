"""Batch driver: process every orbit in a FAST CDF directory (port of ``fast/batch_directory.py``).

Behavioral parity with reference fast/batch_directory.py:32-514: identical
progress-JSON keys (``{y}_{z}_last_orbit`` cursor, ``{y}_{z}_error_plotting``
list, per-instrument ``{inst}_{y}_{z}_error-{reason}`` /
``{inst}_{y}_{z}_timed_out`` / ``orbit_{y}_{z}_timed_out`` taxonomy), the
optional extrema pre-pass, raw + given-extrema double submission, a 0.2 s
responsive wait loop, double-interrupt SIGINT/SIGTERM escalation, and one
retry pass of timed-out orbits with a shrunken pool.

Concurrency is thread-based: worker threads overlap CDF decode, composite
and PNG encode (PIL and zlib release the interpreter lock) while the
device work of every thread queues on the card's stream.  ``max_workers``
sizes the thread pool (:func:`..render.backend.recommended_workers`).
Multi-process runs read their rank and world size from
``torch.distributed`` when it is initialised.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import signal
import threading
from typing import Any

from configurable_spectrograms_torch.constants import DEFAULT_ZOOM_WINDOW_MINUTES
from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
from configurable_spectrograms_torch.data.orbit_discovery import (
    classify_error_reason,
    discover_orbit_files,
)
from configurable_spectrograms_torch.fast.constants import (
    FAST_CDF_DATA_FOLDER_PATH,
    FAST_OUTPUT_BASE,
    FAST_PLOTTING_PROGRESS_JSON,
)
from configurable_spectrograms_torch.fast.extrema import compute_global_extrema
from configurable_spectrograms_torch.fast.process_orbit import FAST_process_single_orbit
from configurable_spectrograms_torch.utils.logging import (
    configure_log_batch,
    flush_log_buffer,
    log_exception,
)
from configurable_spectrograms_torch.utils.process import terminate_all_child_processes
from configurable_spectrograms_torch.utils.progress import (
    add_to_orbit_list,
    atomic_write_json,
    tqdm_or_none,
)

_INSTRUMENT_KEYS = ("ees", "eeb", "ies", "ieb")


class _ProgressLedger:
    """Cumulative progress bookkeeping with the reference's taxonomy.

    Completions fold into one in-memory state dict (seeded from disk once)
    that is persisted every ``flush_batch_size`` completions plus forced
    finals -- the reference's persistence cadence and key schema
    (reference fast/batch_directory.py:248-334).  Accumulating in memory
    (rather than re-reading the file per completion) means a throttled
    write never discards the intermediate completions' updates.
    """

    def __init__(self, path: str | None, y_scale: str, z_scale: str, flush_batch_size: int):
        self.path = path
        self._jobs_left: dict[int, int] = {}  # unfinished jobs per declared orbit (expect(), then advance())
        self._order: list[int] = []  # the orbits in cursor order
        self._next = 0  # index into _order of the first orbit with a job left
        self.cursor_key = f"{y_scale}_{z_scale}_last_orbit"
        self.error_key = f"{y_scale}_{z_scale}_error_plotting"
        self.orbit_timeout_key = f"orbit_{y_scale}_{z_scale}_timed_out"
        self.y_scale, self.z_scale = y_scale, z_scale
        self.flush_every = max(1, flush_batch_size)
        self._since_flush = 0
        self._state: dict[str, Any] | None = None

    def read(self) -> dict[str, Any]:
        if self.path is None:
            return {}
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def state(self) -> dict[str, Any]:
        """The cumulative in-memory progress state (disk-seeded once).

        Updates fold into THIS dict, not a fresh per-completion disk read:
        the throttled ``write`` persists only every ``flush_every``-th
        call, so folding into re-read disk state would silently discard
        the other completions' cursor/taxonomy updates.
        """
        if self._state is None:
            loaded = self.read()
            self._state = loaded if isinstance(loaded, dict) else {}
        return self._state

    def load_resume_state(self, ignore: bool) -> tuple[int | None, set[int]]:
        """Return (last completed orbit, error orbit set) from disk."""
        if self.path is None or ignore:
            return None, set()
        state = self.state()
        return state.get(self.cursor_key), set(state.get(self.error_key, []))

    def write(self, state: dict[str, Any], force: bool = False) -> None:
        if self.path is None:
            return
        self._since_flush += 1
        if not force and self._since_flush < self.flush_every:
            return
        self._since_flush = 0
        try:
            atomic_write_json(self.path, state)
        except OSError as exc:
            log_exception("[FAIL] Could not write progress JSON", exc, level="error")

    def expect(self, jobs: list[int]) -> None:
        """Declare this run's jobs (one orbit number per job); the cursor passes their orbits in ascending order.

        The cursor is the last orbit of an unbroken run of finished orbits:
        it passes an orbit only once all its jobs completed.  The reference
        keeps the most recently completed orbit (docs/parity.md, "The
        progress cursor is the most recently completed orbit"), so after a
        crash its resume skips an orbit whose other job, or whose own job
        behind a later orbit's, never finished, and that orbit's figures
        stay missing or half written.  Whenever jobs finish in order (one
        worker) both rules name the same orbit, so a finished run leaves the
        same progress JSON.
        """
        self._jobs_left = {}
        for orbit in jobs:
            self._jobs_left[orbit] = self._jobs_left.get(orbit, 0) + 1
        self._order = sorted(self._jobs_left)
        self._next = 0

    def advance(self, state: dict[str, Any], orbit: int) -> None:
        """Move the cursor in *state* for one completed job of *orbit*.

        Each completion of an orbit that :meth:`expect` did not declare is
        appended to the cursor order as a finished entry, so with nothing
        declared the cursor is the orbit of the last completed job, the
        reference's rule.
        """
        if orbit in self._jobs_left:
            self._jobs_left[orbit] = max(0, self._jobs_left[orbit] - 1)
        else:
            self._order.append(orbit)
        start = self._next
        while self._next < len(self._order) and self._jobs_left.get(self._order[self._next], 0) == 0:
            self._next += 1
        if self._next > start:
            state[self.cursor_key] = self._order[self._next - 1]

    def record(self, orbit: int, result: dict[str, Any]) -> None:
        """Fold one orbit result into the cumulative taxonomy."""
        if self.path is None:
            return
        state = self.state()
        self.advance(state, orbit)
        state.setdefault(self.error_key, [])
        state.setdefault(self.orbit_timeout_key, [])
        status = result.get("status")
        if status == "error":
            add_to_orbit_list(state, self.error_key, orbit)
            for message in result.get("errors") or []:
                reason = classify_error_reason(message)
                lowered = message.lower()
                inst = next((c for c in _INSTRUMENT_KEYS if c in lowered), "unknown")
                add_to_orbit_list(state, f"{inst}_{self.y_scale}_{self.z_scale}_error-{reason}", orbit)
                add_to_orbit_list(state, f"{self.y_scale}_{self.z_scale}_error-{reason}", orbit)
        elif status == "timeout":
            if result.get("timeout_type") == "orbit":
                add_to_orbit_list(state, self.orbit_timeout_key, orbit)
            else:
                inst = result.get("timeout_instrument") or "unknown_instrument"
                add_to_orbit_list(state, f"{inst}_{self.y_scale}_{self.z_scale}_timed_out", orbit)
        self.write(state)

    def clear_timeout_flags(self, orbit: int) -> None:
        """Drop *orbit* from every ``*_timed_out`` list after a good retry."""
        if self.path is None:
            return
        state = self.state()
        suffix = f"_{self.y_scale}_{self.z_scale}_timed_out"
        changed = False
        for key in [k for k in state if k.endswith(suffix)]:
            values = state.get(key)
            if isinstance(values, list) and orbit in values:
                state[key] = [v for v in values if v != orbit]
                changed = True
        if changed:
            self.write(state, force=True)


#: A tmp sibling older than this (seconds) is swept even when its embedded
#: pid cannot be checked -- no healthy save holds a tmp open for an hour.
_STALE_TMP_AGE_SEC = 3600.0


def _tmp_owner_alive(name: str) -> bool:
    """True when the ``.tmp-{pid}-{tid}`` suffix names a live process.

    Unparseable names (foreign writers, truncated suffixes) report alive
    =False so the age threshold alone decides; a live pid means the tmp
    may belong to a CONCURRENT driver sharing the output tree, whose
    in-flight ``os.replace`` must not be raced.
    """
    tail = name.rsplit(".tmp-", 1)[-1]
    pid_s = tail.split("-", 1)[0]
    if not pid_s.isdigit():
        return False
    try:
        os.kill(int(pid_s), 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        # EPERM etc.: the pid exists but isn't ours -- treat as alive.
        return True


def _sweep_stale_tmp(output_base: str) -> None:
    """Remove stranded ``*.tmp-*`` siblings from a previous crashed run.

    PNG saves are atomic (unique ``.tmp-{pid}-{tid}`` sibling +
    ``os.replace``, render/figure.py save_image), so a SIGKILL mid-write
    leaves a tmp file whose pid/thread-unique name no later process
    reuses.  Drivers sweep them at entry, before any worker writes --
    but only tmp files whose owning pid is dead or whose mtime is older
    than :data:`_STALE_TMP_AGE_SEC`: a concurrently running driver
    sharing the same output tree keeps its live in-flight writes.
    """
    import pathlib
    import time as _time

    now = _time.time()
    try:
        for p in pathlib.Path(output_base).rglob("*.tmp-*"):
            try:
                if _tmp_owner_alive(p.name) and now - p.stat().st_mtime < _STALE_TMP_AGE_SEC:
                    continue
                p.unlink()
            except OSError:
                pass
    except OSError:
        pass


def _install_interrupt_escalation(shutdown_flag: dict) -> None:
    """First SIGINT/SIGTERM requests shutdown; a second forces exit 130."""

    def handler(signum, frame):
        if not shutdown_flag["flag"]:
            log_exception(f"[INTERRUPT] Signal {signum} received. Requesting shutdown...", level="message")
            shutdown_flag["flag"] = True
            try:
                terminate_all_child_processes()
            finally:
                raise KeyboardInterrupt
        log_exception("[INTERRUPT] Second interrupt - forcing immediate exit.", level="message")
        try:
            terminate_all_child_processes()
        finally:
            raise SystemExit(130)

    if threading.current_thread() is threading.main_thread():
        try:
            signal.signal(signal.SIGINT, handler)
            signal.signal(signal.SIGTERM, handler)
        except (ValueError, OSError) as exc:
            log_exception("[WARN] Could not register signal handlers", exc, level="message")


def _extrema_for_combo(
    directory_path: str,
    y_scale: str,
    z_scale: str,
    instrument_order: tuple[str, ...],
    max_processing_percentile: float | None,
    extrema_json_path: str | None,
    flush_batch_size: int,
) -> dict | None:
    """The optional global-extrema pre-pass for one scale combo.

    One shared implementation for both drivers so the extrema arguments
    (including the reference's fixed log floors, reference
    fast/batch_directory.py:159-171) can never drift between them.
    """
    if max_processing_percentile is None:
        return None
    if extrema_json_path is None:
        from configurable_spectrograms_torch.fast.constants import FAST_EXTREMA_JSON_PATH

        extrema_json_path = FAST_EXTREMA_JSON_PATH
    # Under a multi-process run every process scans the full archive (the
    # values are identical by determinism) but each writes its own cache
    # file -- the extrema JSON is a single-writer document.
    return compute_global_extrema(
        directory_path,
        y_scale,
        z_scale,
        instrument_order,
        compute_mins=False,
        extrema_json_path=_per_process_path(extrema_json_path),
        max_percentile=float(max_processing_percentile),
        log_floor_cutoff=0.1,
        log_floor_value=-1.0,
        flush_batch_size=flush_batch_size,
    )


def _process_shard_info() -> tuple[int, int]:
    """``(rank, world_size)``: :func:`..parallel.mesh.process_shard_info` (the group's, once one exists)."""
    from configurable_spectrograms_torch.parallel.mesh import process_shard_info

    return process_shard_info()


def _shard_orbits_across_processes(orbits_sorted: list[int]) -> list[int]:
    """This process's orbit slice under a multi-process run.

    Process ``p`` of ``n`` takes ``orbits_sorted[p::n]`` -- a STABLE
    assignment computed on the full sorted list, so resume after a restart
    re-derives the same slice (the per-process progress cursor then
    applies within it).  Single-process runs pass through untouched.
    """
    pid, n = _process_shard_info()
    if n <= 1:
        return orbits_sorted
    mine = orbits_sorted[pid::n]
    log_exception(
        f"[SHARD] multi-host run: process {pid}/{n} takes {len(mine)} of "
        f"{len(orbits_sorted)} orbits",
        level="message",
    )
    return mine


def _per_process_path(path: str | None) -> str | None:
    """Suffix a state-file path with the process rank under multi-process runs.

    The progress ledger and the extrema cache are single-writer JSON
    documents; two processes flushing one file would interleave torn
    snapshots.  Outputs (PNGs) need no suffix: the orbit sharding makes
    every figure path land on exactly one process, and the stale-tmp
    sweep's pid-liveness guard protects concurrent in-flight writes.
    """
    pid, n = _process_shard_info()
    if n <= 1 or path is None:
        return path
    return f"{path}.proc{pid}"


def _pending_orbits(
    ledger: _ProgressLedger,
    orbits_sorted: list[int],
    ignore_progress_json: bool,
    label: str = "",
) -> list[int]:
    """Orbits still to plot for *ledger*'s combo, honoring cursor + errors.

    The skip rule (strictly past the cursor, minus recorded error orbits)
    is shared by both drivers — reference fast/batch_directory.py:177-213.
    """
    last_done, error_orbits = ledger.load_resume_state(ignore_progress_json)
    if last_done is not None:
        pending = [o for o in orbits_sorted if o > last_done and o not in error_orbits]
        log_exception(
            f"[RESUME] {label}Skipping {len(orbits_sorted) - len(pending)} orbits "
            f"(up to orbit {last_done}). {len(error_orbits)} error orbits will also be skipped.",
            level="message",
        )
    else:
        pending = [o for o in orbits_sorted if o not in error_orbits]
        log_exception(
            f"[RESUME] {label}No previous progress found. Starting from the first orbit. "
            f"{len(error_orbits)} error orbits will be skipped if present.",
            level="message",
        )
    return pending


def _consume_result(
    fut: concurrent.futures.Future,
    orbit: int,
    ledger: _ProgressLedger,
    results: list[dict[str, Any]],
    echo: bool,
) -> None:
    """Fold one completed orbit future into *results* and the ledger."""
    try:
        result = fut.result()
    except Exception as exc:
        log_exception(f"[BATCH] Orbit {orbit} generated an exception", exc, level="error")
        result = {"orbit": orbit, "status": "error", "errors": [str(exc)]}
        results.append(result)
        # Exceptions that escaped the worker get an extra unknown_* key
        # (reference fast/batch_directory.py:266-290).
        if ledger.path is not None:
            state = ledger.state()
            ledger.advance(state, orbit)
            add_to_orbit_list(state, ledger.error_key, orbit)
            reason = classify_error_reason(str(exc))
            add_to_orbit_list(state, f"unknown_{ledger.y_scale}_{ledger.z_scale}_error-{reason}", orbit)
            add_to_orbit_list(state, f"{ledger.y_scale}_{ledger.z_scale}_error-{reason}", orbit)
            ledger.write(state)
        return
    results.append(result)
    if echo:
        line = f"[BATCH] Completed orbit {orbit}: {result.get('status')}"
        tqdm = tqdm_or_none()
        if tqdm is None:
            print(line)
        else:
            tqdm.write(line)
    ledger.record(orbit, result)


def _run_job_pool(
    jobs: list[tuple[tuple, int, Any]],
    max_workers: int,
    shutdown: dict,
    consume,
    bar_desc: str,
    show_bar: bool,
    on_drained=None,
) -> None:
    """Run ``FAST_process_single_orbit`` jobs on a thread pool.

    *jobs* entries are ``(worker_args, orbit, context)``; *consume* is
    called as ``consume(future, orbit, context)`` on the calling thread for
    each completion (so ledger folding stays single-threaded).  Reproduces
    the reference driver's responsive 0.2 s wait loop and interrupt
    behavior (reference fast/batch_directory.py:336-433): on shutdown or
    ``KeyboardInterrupt`` the pool is cancelled and ``KeyboardInterrupt``
    propagates; *on_drained* (if given) runs after the wait loop but
    before the shutdown re-raise, mirroring the driver's pre-raise
    force-flush.  ``CST_PROFILE_DIR`` set: the plotting pass runs under
    :func:`..utils.timing.device_trace` and drops a Chrome trace there.
    """
    from configurable_spectrograms_torch.render.backend import recommended_workers
    from configurable_spectrograms_torch.utils.timing import device_trace

    executor: concurrent.futures.Executor | None = None
    profile_dir = os.environ.get("CST_PROFILE_DIR")
    try:
        executor = concurrent.futures.ThreadPoolExecutor(max_workers=recommended_workers(max_workers))
        future_meta: dict[concurrent.futures.Future, tuple[int, Any]] = {}
        for args, orbit, ctx in jobs:
            if shutdown["flag"]:
                break
            future_meta[executor.submit(FAST_process_single_orbit, *args)] = (orbit, ctx)
        outstanding = set(future_meta)

        tqdm = tqdm_or_none() if show_bar else None
        bar = None if tqdm is None else tqdm(total=len(outstanding), desc=bar_desc, unit="orbit", leave=False)
        try:
            with device_trace(profile_dir):
                while outstanding and not shutdown["flag"]:
                    done, _ = concurrent.futures.wait(
                        outstanding, timeout=0.2, return_when=concurrent.futures.FIRST_COMPLETED
                    )
                    for fut in done:
                        outstanding.discard(fut)
                        orbit, ctx = future_meta[fut]
                        consume(fut, orbit, ctx)
                        if bar is not None:
                            bar.set_postfix(orbit=orbit)
                            bar.update(1)
        finally:
            if bar is not None:
                bar.close()

        if on_drained is not None:
            on_drained()

        if shutdown["flag"]:
            log_exception("[INTERRUPT] Shutdown requested; cancelling remaining futures.", level="message")
            for fut in outstanding:
                fut.cancel()
            executor.shutdown(wait=False, cancel_futures=True)
            raise KeyboardInterrupt
    except KeyboardInterrupt as exc:
        log_exception(
            f"[INTERRUPT] KeyboardInterrupt caught. Shutting down workers... Exception: {exc}",
            level="message",
        )
        if executor is not None:
            executor.shutdown(wait=False, cancel_futures=True)
        raise
    finally:
        if executor is not None:
            try:
                executor.shutdown(wait=False, cancel_futures=True)
            except Exception:
                pass


def _worker_args(orbit: int, files: dict[str, str], filtered_orbits_dataframe, zoom_duration_minutes: float,
                 y_scale: str, z_scale: str, instrument_order: tuple[str, ...], colormap: str,
                 output_base: str, orbit_timeout_seconds: float, instrument_timeout_seconds: float,
                 extrema: dict | None, override_plots: bool, cusp_marker_style: str,
                 cusp_marker_kwargs: dict | None) -> tuple:
    """``FAST_process_single_orbit``'s positional arguments for one job."""
    return (orbit, files, filtered_orbits_dataframe, zoom_duration_minutes, y_scale, z_scale,
            instrument_order, colormap, output_base, orbit_timeout_seconds, instrument_timeout_seconds,
            extrema, override_plots, cusp_marker_style, cusp_marker_kwargs)


def FAST_plot_spectrograms_directory(
    directory_path: str = FAST_CDF_DATA_FOLDER_PATH,
    output_base: str = FAST_OUTPUT_BASE,
    y_scale: str = "linear",
    z_scale: str = "log",
    zoom_duration_minutes: float = DEFAULT_ZOOM_WINDOW_MINUTES,
    instrument_order: tuple[str, ...] = _INSTRUMENT_KEYS,
    verbose: bool = True,
    progress_json_path: str | None = FAST_PLOTTING_PROGRESS_JSON,
    ignore_progress_json: bool = False,
    use_tqdm: bool | None = None,
    colormap: str = "viridis",
    cusp_marker_style: str = "both",
    cusp_marker_kwargs: dict | None = None,
    max_workers: int = 4,
    orbit_timeout_seconds: int | float = 60,
    instrument_timeout_seconds: int | float = 30,
    retry_timeouts: bool = True,
    flush_batch_size: int = 10,
    log_flush_batch_size: int | None = None,
    max_processing_percentile: float | None = None,
    override_plots: bool = True,
    extrema_json_path: str | None = None,
) -> list[dict[str, Any]]:
    """Batch process ESA spectrogram plots for all orbits in a directory.

    Parameter-for-parameter parity with the reference driver
    (reference fast/batch_directory.py:32-130).  With
    ``max_processing_percentile`` set, a resumable global-extrema pass runs
    first and each orbit is submitted twice (raw and given-extrema argument
    sets); progress persists per scale combo, so interrupted runs resume
    past completed orbits and skip recorded error orbits.  Returns the
    per-orbit result dicts (including any retry results); re-raises
    ``KeyboardInterrupt`` so multi-combo callers can stop.
    """
    shutdown = {"flag": False}
    _install_interrupt_escalation(shutdown)

    filtered_orbits_dataframe = load_filtered_orbits()
    configure_log_batch(log_flush_batch_size or flush_batch_size)

    global_extrema = _extrema_for_combo(
        directory_path,
        y_scale,
        z_scale,
        instrument_order,
        max_processing_percentile,
        extrema_json_path,
        flush_batch_size,
    )

    _sweep_stale_tmp(output_base)
    orbit_map = discover_orbit_files(directory_path, instrument_order)
    orbits_sorted = _shard_orbits_across_processes(sorted(orbit_map))
    ledger = _ProgressLedger(
        _per_process_path(progress_json_path), y_scale, z_scale, flush_batch_size
    )
    pending_orbits = _pending_orbits(ledger, orbits_sorted, ignore_progress_json)

    def worker_args(orbit: int, extrema: dict | None) -> tuple:
        return _worker_args(orbit, orbit_map[orbit], filtered_orbits_dataframe, zoom_duration_minutes,
                            y_scale, z_scale, instrument_order, colormap, output_base, orbit_timeout_seconds,
                            instrument_timeout_seconds, extrema, override_plots, cusp_marker_style,
                            cusp_marker_kwargs)

    jobs: list[tuple[tuple, int, Any]] = []
    for orbit in pending_orbits:
        jobs.append((worker_args(orbit, None), orbit, None))
        if global_extrema is not None:
            jobs.append((worker_args(orbit, global_extrema), orbit, None))
    ledger.expect([orbit for _, orbit, _ in jobs])

    results: list[dict[str, Any]] = []
    show_bar = bool(use_tqdm) if use_tqdm is not None else False

    _run_job_pool(
        jobs,
        max_workers,
        shutdown,
        lambda fut, orbit, _ctx: _consume_result(fut, orbit, ledger, results, verbose and show_bar),
        f"Plotting - {y_scale} / {z_scale}",
        show_bar,
        on_drained=lambda: ledger.write(ledger.state(), force=True),
    )

    flush_log_buffer(force=True)

    if retry_timeouts and not shutdown["flag"]:
        results = _retry_timeouts_once(results, orbit_map, worker_args, max_workers, ledger)
    return results


def _normalize_combo(combo) -> tuple[str, str, str]:
    """Accept ``(y, z, colormap)`` triples or ScaleCombo-like objects."""
    if hasattr(combo, "y_scale"):
        return (combo.y_scale, combo.z_scale, combo.colormap)
    y_scale, z_scale, colormap = combo
    return (str(y_scale), str(z_scale), str(colormap))


def FAST_plot_spectrograms_multi(
    directory_path: str = FAST_CDF_DATA_FOLDER_PATH,
    combos: tuple = (
        ("linear", "linear", "viridis"),
        ("linear", "log", "cividis"),
        ("log", "linear", "plasma"),
        ("log", "log", "inferno"),
    ),
    output_base: str = FAST_OUTPUT_BASE,
    zoom_duration_minutes: float = DEFAULT_ZOOM_WINDOW_MINUTES,
    instrument_order: tuple[str, ...] = _INSTRUMENT_KEYS,
    verbose: bool = True,
    progress_json_path: str | None = FAST_PLOTTING_PROGRESS_JSON,
    ignore_progress_json: bool = False,
    use_tqdm: bool | None = None,
    cusp_marker_style: str = "both",
    cusp_marker_kwargs: dict | None = None,
    max_workers: int = 4,
    orbit_timeout_seconds: int | float = 60,
    instrument_timeout_seconds: int | float = 30,
    retry_timeouts: bool = True,
    flush_batch_size: int = 10,
    log_flush_batch_size: int | None = None,
    max_processing_percentile: float | None = None,
    override_plots: bool = True,
    extrema_json_path: str | None = None,
) -> list[dict[str, Any]]:
    """Orbit-major scheduling of several scale combos over one directory.

    Produces byte-identical outputs, progress keys, and resume semantics
    to running :func:`FAST_plot_spectrograms_directory` once per combo
    (the reference flagship's loop, reference
    batch_multi_plot_FAST_spectrograms.py:88-103), but interleaves the
    work orbit-major: every combo's raw/given jobs for an orbit run
    adjacently, so a decoded CDF is reused by all of them while resident
    (reuse distance = one orbit instead of the whole archive).  Combo-major
    re-decodes the archive once per combo whenever it exceeds the dataset
    cache budget (``CST_DATASET_CACHE_BYTES``).  The extrema pre-pass, when
    ``max_processing_percentile`` is set, makes its own scan of the archive
    up front.

    Per-combo progress cursors, error lists, and taxonomy keys fold into
    ONE shared state for the progress JSON so interleaved completions from
    different combos never clobber each other's keys; a run interrupted
    under either scheduling resumes correctly under the other.  Returns
    the per-orbit result dicts grouped in combo order (matching the
    sequential loop's concatenation).
    """
    shutdown = {"flag": False}
    _install_interrupt_escalation(shutdown)

    normalized = [_normalize_combo(c) for c in combos]
    filtered_orbits_dataframe = load_filtered_orbits()
    configure_log_batch(log_flush_batch_size or flush_batch_size)

    extrema_by_combo = [
        _extrema_for_combo(
            directory_path,
            y_scale,
            z_scale,
            instrument_order,
            max_processing_percentile,
            extrema_json_path,
            flush_batch_size,
        )
        for y_scale, z_scale, _cmap in normalized
    ]

    _sweep_stale_tmp(output_base)
    orbit_map = discover_orbit_files(directory_path, instrument_order)
    orbits_sorted = _shard_orbits_across_processes(sorted(orbit_map))

    # One shared state dict behind every combo's ledger: interleaved
    # completions write the same progress file, and independent disk-seeded
    # snapshots would let the last flush clobber the other combos' updates.
    ledgers: list[_ProgressLedger] = []
    shared_state: dict[str, Any] | None = None
    for y_scale, z_scale, _cmap in normalized:
        ledger = _ProgressLedger(
            _per_process_path(progress_json_path), y_scale, z_scale, flush_batch_size
        )
        if shared_state is None:
            shared_state = ledger.state()
        else:
            ledger._state = shared_state
        ledgers.append(ledger)

    pending_by_combo: list[set[int]] = [
        set(
            _pending_orbits(
                ledger,
                orbits_sorted,
                ignore_progress_json,
                label=f"{ledger.y_scale}/{ledger.z_scale}: ",
            )
        )
        for ledger in ledgers
    ]

    def worker_args(orbit: int, combo_index: int, extrema: dict | None) -> tuple:
        y_scale, z_scale, colormap = normalized[combo_index]
        return _worker_args(orbit, orbit_map[orbit], filtered_orbits_dataframe, zoom_duration_minutes,
                            y_scale, z_scale, instrument_order, colormap, output_base, orbit_timeout_seconds,
                            instrument_timeout_seconds, extrema, override_plots, cusp_marker_style,
                            cusp_marker_kwargs)

    jobs: list[tuple[tuple, int, Any]] = []
    for orbit in orbits_sorted:
        for i in range(len(normalized)):
            if orbit not in pending_by_combo[i]:
                continue
            jobs.append((worker_args(orbit, i, None), orbit, i))
            if extrema_by_combo[i] is not None:
                jobs.append((worker_args(orbit, i, extrema_by_combo[i]), orbit, i))
    for i, ledger in enumerate(ledgers):
        ledger.expect([orbit for _, orbit, combo in jobs if combo == i])

    results_by_combo: list[list[dict[str, Any]]] = [[] for _ in normalized]
    show_bar = bool(use_tqdm) if use_tqdm is not None else False
    echo = verbose and show_bar

    def force_flush() -> None:
        if ledgers and shared_state is not None:
            ledgers[0].write(shared_state, force=True)

    _run_job_pool(
        jobs,
        max_workers,
        shutdown,
        lambda fut, orbit, i: _consume_result(fut, orbit, ledgers[i], results_by_combo[i], echo),
        f"Plotting - orbit-major ({len(normalized)} combos)",
        show_bar,
        on_drained=force_flush,
    )

    flush_log_buffer(force=True)

    if retry_timeouts and not shutdown["flag"]:
        for i, ledger in enumerate(ledgers):
            results_by_combo[i] = _retry_timeouts_once(
                results_by_combo[i],
                orbit_map,
                lambda orbit, extrema, i=i: worker_args(orbit, i, extrema),
                max_workers,
                ledger,
            )
    return [result for combo_results in results_by_combo for result in combo_results]


def _retry_timeouts_once(
    results: list[dict[str, Any]],
    orbit_map: dict[int, dict[str, str]],
    worker_args,
    max_workers: int,
    ledger: _ProgressLedger,
) -> list[dict[str, Any]]:
    """Retry every timed-out orbit once with a pool of at most two workers
    (reference fast/batch_directory.py:455-492)."""
    timed_out = [r["orbit"] for r in results if r.get("status") == "timeout" and r["orbit"] in orbit_map]
    if not timed_out:
        return results
    log_exception(f"[RETRY] Retrying {len(timed_out)} timed-out orbits once.", level="message")

    merged = {r["orbit"]: r for r in results}
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=min(max_workers, 2)) as pool:
            futures = {pool.submit(FAST_process_single_orbit, *worker_args(o, None)): o for o in timed_out}
            for fut in concurrent.futures.as_completed(futures):
                orbit = futures[fut]
                try:
                    retry_result = fut.result()
                except Exception as exc:
                    log_exception(f"[RETRY] Orbit {orbit} retry failed", exc, level="error")
                    retry_result = {"orbit": orbit, "status": "error", "errors": [str(exc)]}
                else:
                    log_exception(
                        f"[RETRY] Completed orbit {orbit}: {retry_result.get('status')}", level="message"
                    )
                    if retry_result.get("status") == "ok":
                        ledger.clear_timeout_flags(orbit)
                merged[orbit] = retry_result
    except Exception as exc:
        log_exception("[RETRY] Failed to execute retry pool", exc, level="message")
    return list(merged.values())
