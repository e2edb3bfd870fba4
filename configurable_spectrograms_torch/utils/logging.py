"""Buffered, batch-flushed logging shared by every pipeline.

Messages queue in memory and hit disk every ``batch_size`` records so big
batch runs don't pay one write per message (behavioral parity with
reference logging_utils.py:1-145).  The logfile path is set explicitly by
entry points -- importing this module never touches the filesystem.
Thread-safe (the batch drivers log from worker threads).
"""

from __future__ import annotations

import sys
import threading
import traceback
from datetime import datetime
from pathlib import Path


class _Buffer:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.records: list[tuple[str, str]] = []
        self.batch_size = 10
        self.path: str | None = None

    def drain_to_disk(self, force: bool) -> None:
        """Must hold ``self.lock``."""
        if not self.records or (len(self.records) < self.batch_size and not force):
            return
        if self.path is None:
            self.records.clear()
            return
        try:
            with open(self.path, "a") as out:
                for level, text in self.records:
                    out.write(f"[ERROR] {text}\n" if level == "error" else text + "\n")
        except OSError as exc:
            _echo(f"[ERROR] Failed flushing log buffer: {exc}")
        finally:
            self.records.clear()

    def push(self, level: str, text: str, force: bool) -> None:
        with self.lock:
            self.records.append((level, text))
            self.drain_to_disk(force)


_BUF = _Buffer()


def _echo(message: str) -> None:
    """Immediate console output on stderr (tqdm-aware when active).

    stderr keeps stdout clean for machine consumers (bench.py's JSON
    contract, shell pipelines over the CLIs).
    """
    try:
        from tqdm import tqdm

        tqdm.write(message, file=sys.stderr)
    except Exception:
        print(message, file=sys.stderr)


def get_logfile_path(prefix: str, datetime_marker_path: str) -> str:
    """Per-run log path derived from a persistent timestamp marker file.

    The marker is minted on first use and reused afterwards, so reruns of
    one pipeline append to a single log (reference logging_utils.py:21-45).
    """
    marker = Path(datetime_marker_path)
    stamp = marker.read_text().strip() if marker.exists() else ""
    if not stamp:
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        marker.write_text(stamp)
    return f"{prefix}_{stamp}.log"


def set_logfile_path(path: str | None) -> None:
    """Point buffered flushes at *path* (``None`` discards on flush).

    Relative paths are pinned to the current working directory *now*:
    flushes happen later (batched), and a caller that changes directory in
    between must not scatter log files across directories.
    """
    import os

    with _BUF.lock:
        _BUF.path = os.path.abspath(path) if path is not None else None


def configure_log_batch(batch_size: int) -> None:
    """Set how many records accumulate before an automatic flush (min 1)."""
    with _BUF.lock:
        _BUF.batch_size = max(1, int(batch_size))


def log_message(message: str, force_flush: bool = False) -> None:
    """Queue an informational record; flushes at the batch threshold."""
    _BUF.push("info", message, force_flush)


def log_error(message: str, force_flush: bool = False) -> None:
    """Queue an error record and echo it to the console immediately."""
    _echo("[ERROR] " + message)
    _BUF.push("error", message, force_flush)


def flush_log_buffer(force: bool = True) -> None:
    """Flush any queued records to disk now."""
    with _BUF.lock:
        _BUF.drain_to_disk(force)


def log_exception(
    prefix: str,
    exception: BaseException | None = None,
    level: str = "error",
    include_trace: bool = False,
    force_flush: bool = False,
) -> None:
    """Log *prefix*, appending the exception's class and value when given.

    ``level='error'`` echoes to the console; any other level queues
    silently.  ``include_trace`` appends a formatted traceback record
    (reference logging_utils.py:116-145).
    """
    if exception is not None:
        message = f"{prefix} [{type(exception).__name__}]: {exception}"
    else:
        message = str(prefix)
    (log_error if level == "error" else log_message)(message, force_flush=force_flush)
    if include_trace and exception is not None:
        trace = "".join(traceback.format_exception(type(exception), exception, exception.__traceback__))
        log_message("[TRACE]\n" + trace, force_flush=force_flush)
