"""Atomic JSON writes for the extrema cache (``atomic_write_json``)."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Any


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
