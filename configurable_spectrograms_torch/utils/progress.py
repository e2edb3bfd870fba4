"""Resumable JSON progress stores with batched flushing.

The reference persists three JSON state files with batched writes
(reference batch_runner.py:96-137, fast/batch_directory.py:248-334,
fast/extrema.py:185-243).  This module centralizes that pattern: a
:class:`ProgressStore` holds an in-memory dict, counts dirty updates, and
flushes to disk every ``flush_batch_size`` updates with a guaranteed final
flush.  Schema helpers reproduce the reference's exact key layouts so
progress files are interchangeable between the two implementations.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Any

from configurable_spectrograms_torch.utils.logging import log_error


def atomic_write_json(path: str, payload: Any, *, indent: int = 2) -> None:
    """Serialize *payload* to *path* via a same-directory temp file + rename.

    The reference truncate-writes its progress JSONs in place (reference
    batch_runner.py:133, fast/batch_directory.py:258, fast/extrema.py:235),
    so a crash mid-dump leaves a corrupt file and loses the resume state
    the file exists to preserve.  Writing a fresh temp file, fsyncing it,
    and ``os.replace``-ing it keeps every reader seeing either the old or
    the new complete document across process crashes and (on ordered
    filesystems) power loss; the containing directory is deliberately not
    fsynced, so a power cut can still roll back to the previous document
    — never to a torn one.  It also never truncates a writeback-dirty hot
    file, which measured ~1 s open() stalls under full page-cache pressure
    at archive scale (docs/budget.md, 40-orbit run).

    Raises ``OSError`` on any filesystem failure (callers keep their
    existing log-and-continue handling); the temp file is removed on every
    failure path.
    """
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=directory
    )
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=indent)
            f.flush()
            os.fsync(f.fileno())
        # mkstemp creates 0600; keep the destination's visibility (or the
        # conventional 0644 for a fresh file) so other tools can read it.
        try:
            mode = os.stat(path).st_mode & 0o777
        except OSError:
            mode = 0o644
        os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def tqdm_or_none():
    """The ``tqdm`` class, or ``None`` where the package is not installed.

    Progress bars are optional: without ``tqdm`` the same work runs with
    no bar (the card's machine need not carry it).
    """
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm


def add_to_orbit_list(progress_dict: dict, key: str, orbit: int) -> None:
    """Add *orbit* to the sorted, deduplicated list at ``progress_dict[key]``.

    Matches reference fast/orbit_discovery.py:78-89.

    Examples
    --------
    >>> progress = {}
    >>> add_to_orbit_list(progress, "errors", 5)
    >>> add_to_orbit_list(progress, "errors", 3)
    >>> progress["errors"]
    [3, 5]
    """
    progress_dict[key] = sorted(set(progress_dict.get(key, [])) | {orbit})


class ProgressStore:
    """A JSON-backed progress dict with batched flushing.

    Parameters
    ----------
    path : str or None
        JSON file path; ``None`` disables persistence entirely (all methods
        become cheap no-ops on the disk side but the in-memory dict still
        works).
    flush_batch_size : int, default 10
        Number of :meth:`mark_dirty` calls between automatic flushes.
        Values < 1 coerce to 1.  A final :meth:`flush` with ``force=True``
        is always the caller's responsibility (or use as a context manager).
    """

    def __init__(self, path: str | None, flush_batch_size: int = 10):
        self.path = path
        self.flush_batch_size = max(1, int(flush_batch_size))
        self.state: dict[str, Any] = {}
        self._dirty_count = 0

    # -- persistence ------------------------------------------------------

    def load(self, default: dict[str, Any] | None = None) -> dict[str, Any]:
        """Load state from disk (merging over *default*), tolerating errors."""
        self.state = dict(default or {})
        if self.path is not None and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    loaded = json.load(f)
                if isinstance(loaded, dict):
                    self.state.update(loaded)
            except (OSError, json.JSONDecodeError) as exc:
                log_error(f"[PROGRESS] Failed to read progress JSON '{self.path}': {exc}")
        return self.state

    def mark_dirty(self) -> None:
        """Record one update; auto-flush when the batch threshold is met."""
        self._dirty_count += 1
        if self._dirty_count >= self.flush_batch_size:
            self.flush(force=True)

    def flush(self, force: bool = False) -> None:
        """Write state to disk when dirty (or when *force* is True)."""
        if self.path is None:
            return
        if self._dirty_count == 0 and not force:
            return
        if self._dirty_count < self.flush_batch_size and not force:
            return
        try:
            atomic_write_json(self.path, self.state)
            self._dirty_count = 0
        except OSError as exc:
            log_error(f"[PROGRESS] Failed writing progress JSON '{self.path}': {exc}")

    def __enter__(self) -> "ProgressStore":
        return self

    def __exit__(self, *exc_info) -> None:
        self.flush(force=True)

    # -- dict conveniences --------------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        return self.state.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self.state[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.state[key] = value

    def setdefault(self, key: str, default: Any) -> Any:
        return self.state.setdefault(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self.state


def new_generic_progress() -> dict[str, Any]:
    """The generic batch-runner progress schema (reference batch_runner.py:96-102)."""
    return {
        "completed_items": [],
        "errors": [],
        "no_data": [],
        "last_index": -1,
        "schema_version": 1,
    }
