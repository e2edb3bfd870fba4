"""What the mel cell's readers share: a port stage's seconds per figure, and the percentile-quantize roofline.

The roofline takes ``chip_smoke.py``'s ``[kernel]`` rule for the kernel:
the (L, T, E) float32 matrix of a launch read once and its (L, T, E)
uint8 colour indices written once, at the HBM rate of
:data:`harness.roofline.PEAKS`, over the device time of the functions
named :data:`KERNEL_NAME` in the window's trace.  The rule needs only
each launch's matrix shape, which the driver keeps in traced runs.
"""

from __future__ import annotations

from harness import roofline

KERNEL_NAME = "cst_percentile_quantize_kernel"


def stage_per_figure(record: dict, stage: str) -> float | None:
    """Seconds of one of the port's ``utils.timing`` stages over the window's figures."""
    outcome = record["outcome"]
    timer, figures = outcome.get("timer"), outcome.get("attempted")
    if timer is None or not figures or not timer.counts.get(stage):
        return None
    return timer.totals[stage] / figures


def percentile_quantize_bytes(matrix_shape: tuple) -> int:
    """One launch: the float32 matrix read once, the uint8 indices written once."""
    L, T, E = matrix_shape
    return L * T * E * (4 + 1)


def percentile_quantize_share(record: dict) -> float | None:
    """Per cent of the HBM roofline over the window's launches, or None where none ran or none was kept."""
    shapes = record["outcome"].get("launch_shapes", {}).get("percentile_quantize", [])
    by_op = (record.get("device") or {}).get("by_op", {})
    seconds = sum(s for name, s in by_op.items() if KERNEL_NAME in name)
    return roofline.share(sum(percentile_quantize_bytes(s) for s in shapes), seconds)
