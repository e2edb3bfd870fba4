"""Stage timing and optional device profiling (port of ``utils/timing.py``).

A :class:`StageTimer` accumulates named host/device stage durations and
logs a ``[TIMING]`` summary; :func:`device_trace` wraps
``torch.profiler.profile`` (CPU and CUDA activities) so a batch run can
drop a Chrome trace of the host threads and the card's kernels.
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
    """Accumulate named stage durations and log a ``[TIMING]`` summary.

    >>> t = StageTimer("demo")
    >>> with t.stage("load"):
    ...     pass
    >>> sorted(t.totals) == ["load"]
    True
    """

    name: str
    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    #: Instrumented stages run in batch worker threads; unlocked
    #: read-modify-writes would drop increments under contention.
    lock: threading.Lock = field(default_factory=threading.Lock)

    @contextlib.contextmanager
    def stage(self, stage_name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage_name, time.perf_counter() - t0)

    def add(self, stage_name: str, dt: float) -> None:
        with self.lock:
            self.totals[stage_name] = self.totals.get(stage_name, 0.0) + dt
            self.counts[stage_name] = self.counts.get(stage_name, 0) + 1

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
    present; the trace lands in ``log_dir/trace-{pid}-{time_ns}.json``.
    """
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# process-wide stage accounting (opt-in; zero-cost when inactive)
# ---------------------------------------------------------------------------

#: When set, hot-path seams record their stage durations here so an
#: end-to-end run yields a per-stage budget.  ``None`` (the default) keeps
#: production renders free of timing overhead beyond one attribute check.
ACTIVE: StageTimer | None = None


@contextlib.contextmanager
def active_stage(stage_name: str):
    """Record into the process-wide :data:`ACTIVE` timer when one is set."""
    timer = ACTIVE
    if timer is None:
        yield
        return
    with timer.stage(stage_name):
        yield
