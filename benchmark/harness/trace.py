"""What a run records: spans and counters on the host, and the device's trace of the window.

Spans are (name, start, end) on the host's ``perf_counter`` clock, kept in
memory.  The device trace is ``torch.profiler`` with CUDA activity only
(CUPTI): its kernels, copies and sets, reduced to the seconds the device
was busy (the union of their intervals), the seconds by operation name,
and the longest gaps between them, named by the port's stage open at the
time (the driver's host span where no stage is).  A spin kernel launched
at a host time stamp ties the two clocks.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR_KERNEL = "spin_kernel"


class Recorder:
    """Host spans and counters of one run, shared by the driver's threads."""

    def __init__(self) -> None:
        self.spans: list[tuple[str, float, float]] = []
        self.counters: dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.spans.append((name, t0, t1))

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def seconds(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)

    def open_at(self, t: float) -> str:
        """The innermost (latest started) span open at host time *t*, or "harness"."""
        return open_at(self.spans, t) or "harness"


def open_at(intervals, t: float) -> str | None:
    """The name of the latest-started of *intervals* ``(name, t0, t1, ...)`` that contains host time *t*.

    Of a ``StageTimer``'s ``(stage, t0, t1, thread)`` intervals, that is the
    innermost port stage open at *t* on any thread.  None where none contains *t*.
    """
    best = None
    for name, t0, t1, *_ in intervals:
        if t0 <= t <= t1 and (best is None or t0 > best[1]):
            best = (name, t0)
    return best[0] if best else None


class DeviceTrace:
    """``torch.profiler`` over the window, CUDA activity only; :meth:`summary` reduces it."""

    def __init__(self, out_dir: str) -> None:
        self.path = os.path.join(out_dir, "device_trace.json")
        self.prof = None
        self.t_anchor = self.t_end = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_anchor = time.perf_counter()
        torch.cuda._sleep(20000)  # a spin kernel at a known host time, on an idle device
        torch.cuda.synchronize()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def summary(self, rec: Recorder, timer=None, top: int = 10) -> dict:
        """busy_s, window_s, seconds by operation, and the longest idle gaps.

        A gap is named by the port's stage open at its midpoint in *timer*
        (the window's ``utils.timing.StageTimer``), or else by the driver's
        span open then (:meth:`Recorder.open_at`).
        """
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        os.unlink(self.path)
        dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES and "dur" in e]
        if not dev:
            raise RuntimeError("the device trace holds no device operation: the profiler saw no CUDA activity")
        anchor = next((e for e in dev if ANCHOR_KERNEL in e.get("name", "")),
                      min(dev, key=lambda e: float(e["ts"])))
        base = float(anchor["ts"])

        def host(ts_us: float) -> float:
            return self.t_anchor + (ts_us - base) / 1e6

        spans = sorted((host(float(e["ts"])), host(float(e["ts"]) + float(e["dur"])), e["name"])
                       for e in dev if e is not anchor)
        by_op: dict[str, float] = {}
        for t0, t1, name in spans:
            by_op[name] = by_op.get(name, 0.0) + (t1 - t0)
        busy, gaps, cursor = 0.0, [], self.t_anchor
        for t0, t1, _ in spans:
            t0, t1 = max(t0, self.t_anchor), min(t1, self.t_end)
            if t1 <= t0:
                continue
            if t0 > cursor:
                gaps.append((t0 - cursor, 0.5 * (cursor + t0)))
                cursor = t0
            if t1 > cursor:
                busy += t1 - cursor
                cursor = t1
        if self.t_end > cursor:
            gaps.append((self.t_end - cursor, 0.5 * (cursor + self.t_end)))
        gaps.sort(reverse=True)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])
        stages = list(timer.intervals) if timer is not None else []
        return {"busy_s": busy, "window_s": self.t_end - self.t_anchor, "by_op": by_op,
                "device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[open_at(stages, t) or rec.open_at(t), s] for s, t in gaps[:top]]}
