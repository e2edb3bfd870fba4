"""Executor-agnostic batch execution with resumable progress tracking.

:func:`run_batch` is the shared scaffolding (progress-JSON load/merge/
flush, buffered-log flush cadence, ``as_completed`` loop, SIGINT handling)
used by the generic plotting batch and the threaded downloader,
matching the reference's contract (reference batch_runner.py:33-178):
items are identified by ``repr(item)``, statuses are
``ok``/``no_data``/``error``, and the progress schema is
``{completed_items, errors, no_data, last_index, schema_version}``.

One deliberate divergence from the reference: one GPU serves the whole
host, so callers should hand in ``ThreadPoolExecutor`` factories --
worker threads overlap host I/O and PNG encoding while device work
serializes on the CUDA stream.  Process pools still work for purely
host-side workloads.  A copy of the JAX package's ``batch_runner.py``.
"""

from __future__ import annotations

import concurrent.futures
import signal
import sys
from collections.abc import Callable, Iterable
from typing import Any

from configurable_spectrograms_torch.utils.logging import (
    configure_log_batch,
    flush_log_buffer,
    log_error,
    log_message,
)
from configurable_spectrograms_torch.utils.process import terminate_all_child_processes
from configurable_spectrograms_torch.utils.progress import ProgressStore, new_generic_progress


def _sigint_handler(signum, frame) -> None:
    """SIGINT handler that terminates children and exits promptly."""
    log_message("[INFO] SIGINT received. Terminating all child processes and exiting.")
    terminate_all_child_processes()
    sys.exit(1)


def run_batch(
    items: Iterable[Any],
    worker_fn: Callable[[Any], tuple[Any, str]],
    executor_factory: Callable[[], concurrent.futures.Executor],
    progress_json_path: str | None = None,
    ignore_progress_json: bool = False,
    flush_batch_size: int = 10,
    log_flush_batch_size: int | None = None,
    install_signal_handlers: bool = True,
) -> list[tuple[Any, str]]:
    """Run ``worker_fn`` over ``items`` in parallel with resumable progress.

    Parameters mirror the reference's ``run_batch`` exactly
    (reference batch_runner.py:33-82); see module docstring for the
    executor-choice guidance.  Returns ``(item, status)`` per processed
    item; items whose ``repr`` is already in ``completed_items`` are
    skipped on resume.
    """
    previous_sigint = None
    if install_signal_handlers:
        try:
            previous_sigint = signal.getsignal(signal.SIGINT)
            signal.signal(signal.SIGINT, _sigint_handler)
        except (ValueError, OSError) as exc:
            log_message(f"[WARN] Could not install temporary SIGINT handler: {exc}")

    flush_batch_size = max(1, int(flush_batch_size))
    configure_log_batch(log_flush_batch_size or flush_batch_size)

    store = ProgressStore(progress_json_path, flush_batch_size=flush_batch_size)
    if ignore_progress_json:
        store.state = new_generic_progress()
    else:
        store.load(new_generic_progress())
        # Keep only the schema keys (parity with the reference's merge-on-load).
        store.state = {k: store.state.get(k, v) for k, v in new_generic_progress().items()}

    item_list = list(items)
    completed_set = set(store.state.get("completed_items", []))
    pending_items = [item for item in item_list if repr(item) not in completed_set]
    log_message(
        f"[BATCH] Starting batch run with {len(pending_items)} pending / {len(item_list)} total items; "
        f"flush_batch_size={flush_batch_size}"
    )

    results: list[tuple[Any, str]] = []
    processed = 0
    with executor_factory() as executor:
        future_map = {executor.submit(worker_fn, item): item for item in pending_items}
        for finished in concurrent.futures.as_completed(future_map):
            original_item = future_map[finished]
            try:
                item_identifier, status = finished.result()
            except Exception as exc:
                status = "error"
                item_identifier = original_item
                log_error(f"[BATCH-FAIL] Item {original_item} outer exception: {exc}")
            results.append((item_identifier, status))
            item_repr = repr(item_identifier)
            if status == "ok":
                store.state["completed_items"].append(item_repr)
            elif status == "no_data":
                store.state["no_data"].append(item_repr)
            else:
                store.state["errors"].append(item_repr)
            processed += 1
            store.state["last_index"] = processed - 1
            store.mark_dirty()

    store.flush(force=True)
    flush_log_buffer(force=True)
    log_message(
        "[BATCH] Completed batch run: "
        f"{processed} processed (ok={sum(1 for _, s in results if s == 'ok')} "
        f"no_data={sum(1 for _, s in results if s == 'no_data')} "
        f"error={sum(1 for _, s in results if s == 'error')})",
        force_flush=True,
    )
    if install_signal_handlers and previous_sigint is not None:
        try:
            signal.signal(signal.SIGINT, previous_sigint)
        except (ValueError, OSError) as exc:
            log_message(f"[WARN] Could not restore original SIGINT handler: {exc}")
    return results
