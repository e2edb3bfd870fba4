"""Process-tree management helpers used during batch shutdown handling."""

from __future__ import annotations


def terminate_all_child_processes() -> None:
    """Best-effort terminate all child processes of the current process.

    Uses :mod:`psutil` (imported lazily) to enumerate child processes
    recursively and ``terminate()`` each; exceptions are suppressed because
    this runs during best-effort shutdown (reference process_utils.py:4-29).
    """
    try:
        import psutil
    except ImportError:
        return
    try:
        children = psutil.Process().children(recursive=True)
    except Exception:
        return
    for child in children:
        try:
            child.terminate()
        except Exception:
            pass
