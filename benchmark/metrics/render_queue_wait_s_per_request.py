"""Seconds of the port's ``render_queue_wait`` stage per render request: from its enqueue on a worker
until the coalescer's dispatcher took an in-flight slot for its group."""

from harness.readers import stage_per_call


def read(record: dict) -> float | None:
    return stage_per_call(record, "render_queue_wait")
