"""Render coalescer: natural micro-batching + pipelined device dispatch (port of ``render/service.py``).

The batch drivers run several worker threads, each rendering its own
figures.  The coalescer routes every request through one dispatcher thread
that, each time it wakes, drains *everything* queued and rasterizes
same-geometry panels in one pooled call:

* under concurrency, batches form naturally (requests arriving while a
  dispatch is being enqueued are pooled into the next one);
* a lone request is dispatched immediately -- there is no artificial
  delay, so single-stream latency is unchanged;
* on the device backend the dispatcher only *enqueues* each batch
  (:func:`..render.dispatch.enqueue_render_panels`: pinned uploads, kernel
  launches, one packed D2H into pinned memory) and hands the
  :class:`..render.drain.PendingRender` to a drainer thread, so batch N+1's
  uploads and launches overlap batch N's readback instead of serializing
  behind it.  At most :data:`MAX_INFLIGHT` batches hold device buffers at
  once; the dispatcher blocks past that, which simply deepens the next
  coalesce.

Disable with ``CST_RENDER_COALESCE=0`` (requests then render inline on the
calling thread).  A copy of the JAX package's module without its
``prefer_latency`` routing, which chose between a TPU link and the host.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

from configurable_spectrograms_torch.utils import timing


@dataclass
class _Request:
    panels: list
    tile_h: int
    tile_w: int
    future: Future = field(default_factory=Future)
    #: ``perf_counter`` at enqueue while a stage timer is active (else None).
    t_enqueued: float | None = None


#: Batches enqueued but not yet drained (the JAX package's default depth).
MAX_INFLIGHT = 3


def coalescing() -> bool:
    """Whether a non-empty render is handed to the dispatcher thread (``CST_RENDER_COALESCE`` is not ``0``).

    When it is, the calling thread blocks on a future; when it is not, the
    render runs inline on the calling thread.
    """
    return os.environ.get("CST_RENDER_COALESCE", "1") != "0"


class RenderCoalescer:
    """Single-dispatcher render queue (see module docstring)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: list[_Request] = []
        self._running = False
        self._inflight = threading.Semaphore(MAX_INFLIGHT)

    def _ensure_thread(self) -> None:
        """Start the dispatcher if needed.  Caller must hold the lock.

        The liveness flag flips only under the lock (not ``is_alive``, which
        races with a dispatcher that has decided to exit but not yet died).
        """
        if not self._running:
            self._running = True
            threading.Thread(target=self._run, daemon=True, name="render-coalescer").start()

    def render(self, panels: list, tile_h: int, tile_w: int) -> list[dict]:
        from configurable_spectrograms_torch.render.dispatch import device_render_panels

        if not coalescing() or not panels:
            return device_render_panels(panels, tile_h, tile_w)
        req = _Request(panels, tile_h, tile_w)
        if timing.ACTIVE is not None:
            req.t_enqueued = time.perf_counter()
        with self._lock:
            self._queue.append(req)
            self._ensure_thread()
            self._wake.notify()
        with timing.active_stage("render_wait"):
            return req.future.result()

    @staticmethod
    def _note_queue_wait(reqs: list[_Request]) -> None:
        """Each request's wait from its enqueue until its group won an in-flight slot (``render_queue_wait``)."""
        timer = timing.ACTIVE
        if timer is None:
            return
        now = time.perf_counter()
        for r in reqs:
            if r.t_enqueued is not None:
                timer.add("render_queue_wait", now - r.t_enqueued, now)

    @staticmethod
    def _resolve(reqs: list[_Request], results: list[dict]) -> None:
        pos = 0
        for r in reqs:
            r.future.set_result(results[pos : pos + len(r.panels)])
            pos += len(r.panels)

    def _drain_async(self, pending, reqs: list[_Request]) -> None:
        """Finish one enqueued batch on a drainer thread; its in-flight slot frees when its buffers are consumed."""

        def _drain():
            try:
                self._resolve(reqs, pending.wait())
            except BaseException as exc:  # noqa: BLE001 - futures must never hang
                # BaseException included: a non-Exception escaping here would
                # leave every pooled request's future unresolved, and the
                # workers block in future.result() with no timeout.
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(exc)
            finally:
                self._inflight.release()

        threading.Thread(target=_drain, daemon=True, name="render-drain").start()

    def _run(self) -> None:
        from configurable_spectrograms_torch.render.dispatch import enqueue_render_panels

        batch: list[_Request] = []
        try:
            while True:
                with self._lock:
                    while not self._queue:
                        self._wake.wait(timeout=5.0)
                        if not self._queue:
                            self._running = False  # idle; the next request restarts us
                            return
                    batch = self._queue
                    self._queue = []

                # Pool same-geometry requests into one call.
                by_geometry: dict[tuple[int, int], list[_Request]] = {}
                for req in batch:
                    by_geometry.setdefault((req.tile_h, req.tile_w), []).append(req)
                for (tile_h, tile_w), reqs in by_geometry.items():
                    all_panels = [p for r in reqs for p in r.panels]
                    self._inflight.acquire()
                    self._note_queue_wait(reqs)
                    try:
                        pending = enqueue_render_panels(all_panels, tile_h, tile_w)
                    except Exception as exc:
                        self._inflight.release()
                        for r in reqs:
                            r.future.set_exception(exc)
                        continue
                    if pending.has_device_work():
                        # Device buckets in flight: drain on a side thread so
                        # the next batch's uploads overlap this readback.
                        self._drain_async(pending, reqs)
                    else:
                        # Host batch: the results are complete already.
                        self._inflight.release()
                        try:
                            self._resolve(reqs, pending.wait())
                        except Exception as exc:
                            for r in reqs:
                                if not r.future.done():
                                    r.future.set_exception(exc)
                batch = []
        except BaseException as exc:  # e.g. MemoryError/KeyboardInterrupt
            # The dispatcher is dying: fail every drained-but-unresolved
            # future and clear _running so the next render() restarts a
            # fresh dispatcher.
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)
            with self._lock:
                self._running = False
            raise


_COALESCER = RenderCoalescer()


def coalesced_render(panels: list, tile_h: int, tile_w: int) -> list[dict]:
    """Render through the process-wide coalescer."""
    return _COALESCER.render(panels, tile_h, tile_w)
