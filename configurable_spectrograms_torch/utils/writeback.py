"""Paced page-cache writeback for bulk PNG output.

Archive-scale batches write gigabytes of PNGs.  Left to the kernel, that
output accumulates as dirty page cache until writeback throttling stalls
every other I/O the run needs (the JAX package's own 40-orbit run on its
TPU host measured ~1 s truncating opens of the progress ledger,
docs/budget.md; not measured for the port).  The reference has the same
failure mode (its process pool writes the same bytes through the same
page cache; reference fast/process_orbit.py:98-117) -- it just never ran
at a scale that exposed it.

The fix is to keep the number of dirty pages bounded: a single daemon
thread drains a queue of just-written paths, ``fsync``-ing each file
(forcing its pages to disk *off* the render threads) and then
``posix_fadvise(..., POSIX_FADV_DONTNEED)``-ing them so the now-clean
pages leave the cache immediately.  Render threads only enqueue -- they
never block on the disk -- and the writeback debt can never exceed the
queue depth times the file size.

Disable with ``CST_WRITEBACK_PACE=0`` (e.g. when the output lands on
tmpfs, where fsync is free but pointless).

A copy of the JAX package's ``utils/writeback.py``.
"""

from __future__ import annotations

import os
import queue
import threading

_QUEUE_DEPTH = 64

_state = {"thread": None, "q": None}
_lock = threading.Lock()


def _enabled() -> bool:
    return os.environ.get("CST_WRITEBACK_PACE", "1") != "0"


def _drain(q: "queue.Queue[str | None]") -> None:
    while True:
        path = q.get()
        if path is None:
            return
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            continue
        try:
            os.fsync(fd)
            if hasattr(os, "posix_fadvise"):
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        except OSError:
            pass
        finally:
            os.close(fd)


def note_written(path: str) -> None:
    """Queue *path* for paced writeback (non-blocking, best-effort).

    Called after every bulk image write (render/figure.save_image).  A
    full queue drops the entry -- the pacer is an optimization, never a
    correctness dependency -- though at depth 64 that only happens when
    the disk is slower than the renderer by a wide margin, which is
    exactly when shedding is correct.
    """
    if not _enabled():
        return
    q = _state["q"]
    if q is None:
        with _lock:
            q = _state["q"]
            if q is None:
                q = queue.Queue(maxsize=_QUEUE_DEPTH)
                t = threading.Thread(target=_drain, args=(q,), daemon=True,
                                     name="writeback-pacer")
                t.start()
                _state["q"], _state["thread"] = q, t
    try:
        q.put_nowait(path)
    except queue.Full:
        pass
