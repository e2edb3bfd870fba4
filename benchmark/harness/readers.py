"""Small reductions the per-layer metric readers share.

A reader gets the traced run's record: ``recorder`` (host spans and
counters), ``outcome`` (what the driver's window returned: its passes or
figures, the stage timer, the shapes and lane tensors of the kernels' launches) and ``device``
(the device trace's summary).  It returns a number, or None where the run
gave it nothing to read.
"""

from __future__ import annotations


def stage_per_call(record: dict, stage: str) -> float | None:
    """Seconds per call of one of the port's ``utils.timing`` stages (summed over worker threads)."""
    timer = record["outcome"].get("timer")
    if timer is None or not timer.counts.get(stage):
        return None
    return timer.totals[stage] / timer.counts[stage]


def idle_pct(record: dict) -> float | None:
    dev = record["device"]
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def per_file(record: dict, key: str) -> float | None:
    """A pass counter summed over the window's passes, over the files those passes read."""
    passes = record["outcome"].get("passes") or []
    files = sum(p["files"] for p in passes)
    return sum(p[key] for p in passes) / files if files else None


def kernel_roofline(record: dict, kernel: str) -> float | None:
    """A kernel's share of the HBM roofline over the window's launches, counted once the window has closed."""
    from harness import roofline

    launches = record["outcome"].get("launch_lanes", {}).get(kernel, [])
    nbytes = sum(roofline.launch_bytes(kernel, shape, *(t.cpu().numpy() for t in lanes))
                 for shape, *lanes in launches)
    return roofline.share(nbytes, roofline.kernel_seconds(record["device"]["by_op"], kernel))
