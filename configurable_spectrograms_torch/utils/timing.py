"""Stage timing and optional device profiling (port of ``utils/timing.py``).

A :class:`StageTimer` accumulates named host/device stage durations, keeps
each stage's interval on the ``time.perf_counter`` clock, and logs a
``[TIMING]`` summary; :func:`device_trace` wraps ``torch.profiler.profile``
(CPU and CUDA activities, every thread) so a batch run can drop a Chrome
trace of the host threads, the port's stages and the card's kernels.

The stages the port records through :func:`active_stage` (one interval
per call, never per lane or element):

* ``cdf_decode``: a dataset-cache miss's decode of a FAST CDF (``data.cdf_utils``)
* ``prepass_stats``: a chunk's stack, upload, collapse launch and counts
  and histogram back; ``prepass_host_collapse``: a file's host collapse
  for the exact tracker; ``prepass_tracker``: a file's tracker add and its
  percentile reads, a regather's decode nested (``fast.extrema``)
* ``render_wait``: a worker's wait for its panels; ``render_queue_wait``:
  a request's wait in the coalescer's queue and for an in-flight slot,
  measured across threads (``render.service``)
* ``device_dispatch``: the host's enqueue of a device render
  (``render.dispatch``); ``device_readback``: its wait for the copy back
  (``render.drain``)
* ``composite``, ``png_encode``: a figure's compositing and encode
  (``render.figure``); ``png_stripe``: one row stripe of that encode, run
  on the encoder's native threads and added with its interval by
  ``render.fastpng.write_png_rgb``
* ``wav_load``: the audio CLI's WAV parse and read, and on the int16 path
  the copy's enqueue (``cli.audio``); ``pcm_upload``: inside it, on that
  path only (a 16-bit mono WAV on the device back end), the enqueue of the
  int16 samples' copy to the device and of their widening to float32
* ``mel_filterbank``: a build of the mel weights (``ops.stft``: once in
  ``audio_spectrogram_dataset`` for the centres, once more in
  ``mel_spectrogram`` with the weights' upload, which waits for the STFT
  queued before it); ``mel_project``: the projection's enqueue;
  ``spectrogram_readback``: the device spectrogram's copy to the host,
  which waits for the STFT and the projection
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

from configurable_spectrograms_torch.utils.logging import log_message


@dataclass
class StageTimer:
    """Accumulate named stage durations and intervals; log a ``[TIMING]`` summary.

    >>> t = StageTimer("demo")
    >>> with t.stage("load"):
    ...     pass
    >>> sorted(t.totals) == ["load"], [i[0] for i in t.intervals]
    (True, ['load'])
    """

    name: str
    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    #: ``(stage, t0, t1, thread ident)`` of each recorded stage, on the
    #: ``time.perf_counter`` clock.  A wait measured across threads
    #: (:meth:`add` with ``t_end``) belongs to no one thread: ident ``None``.
    intervals: list[tuple[str, float, float, int | None]] = field(default_factory=list)
    #: Instrumented stages run in batch worker threads; unlocked
    #: read-modify-writes would drop increments under contention.
    lock: threading.Lock = field(default_factory=threading.Lock)

    @contextlib.contextmanager
    def stage(self, stage_name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._keep(stage_name, t1 - t0, (stage_name, t0, t1, threading.get_ident()))

    def add(self, stage_name: str, dt: float, t_end: float | None = None) -> None:
        """Count *dt* seconds under *stage_name*; with *t_end* (a ``perf_counter`` reading) keep its interval too.

        For a wait that starts on one thread and ends on another: the
        thread that ends it passes the end it read.
        """
        self._keep(stage_name, dt, None if t_end is None else (stage_name, t_end - dt, t_end, None))

    def _keep(self, stage_name: str, dt: float, interval: tuple | None) -> None:
        with self.lock:
            self.totals[stage_name] = self.totals.get(stage_name, 0.0) + dt
            self.counts[stage_name] = self.counts.get(stage_name, 0) + 1
            if interval is not None:
                self.intervals.append(interval)

    def log_summary(self) -> None:
        parts = ", ".join(
            f"{k}={self.totals[k]:.3f}s/{self.counts[k]}x" for k in sorted(self.totals)
        )
        log_message(f"[TIMING] {self.name}: {parts}")


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Profile a block with ``torch.profiler`` and write a Chrome trace into *log_dir*.

    A ``None`` log_dir is a no-op, so call sites can thread an optional
    setting straight through.  CUDA activity is recorded when a card is
    present, and the host activity of every thread; the trace lands in
    ``log_dir/trace-{pid}-{time_ns}.json``.  While it runs, each
    :func:`active_stage` is also a ``torch.profiler.record_function``
    range, so the port's stages show on the kernels' timeline; with no
    :data:`ACTIVE` timer set, one of its own records them and logs its
    ``[TIMING]`` summary at the end.
    """
    if log_dir is None:
        yield
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    global ACTIVE, _PROFILING
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    own = StageTimer("profile") if ACTIVE is None else None
    if own is not None:
        ACTIVE = own
    _PROFILING = True
    # Without profile_all_threads Kineto records the profiling thread's host activity alone.
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    try:
        with profile(activities=activities, experimental_config=every_thread) as prof:
            yield
    finally:
        _PROFILING = False
        if own is not None and ACTIVE is own:
            ACTIVE = None
            own.log_summary()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# process-wide stage accounting (opt-in; zero-cost when inactive)
# ---------------------------------------------------------------------------

#: When set, hot-path seams record their stage durations here so an
#: end-to-end run yields a per-stage budget.  ``None`` (the default) keeps
#: production renders free of timing overhead beyond one attribute check.
ACTIVE: StageTimer | None = None
#: Set while :func:`device_trace` runs: stages open profiler ranges too.
_PROFILING = False


@contextlib.contextmanager
def active_stage(stage_name: str):
    """Record into the process-wide :data:`ACTIVE` timer when one is set (and the profiler's trace, while one runs)."""
    timer = ACTIVE
    if timer is None:
        yield
        return
    if not _PROFILING:
        with timer.stage(stage_name):
            yield
        return
    from torch.profiler import record_function

    with record_function(stage_name), timer.stage(stage_name):
        yield
