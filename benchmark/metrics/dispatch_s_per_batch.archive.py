"""Seconds of the port's ``device_dispatch`` stage per dispatched batch: the host's enqueue of a device
render (uploads, bounds, launches, the packed copy back queued), on the coalescer's dispatcher."""

from harness.readers import stage_per_call


def read(record: dict) -> float | None:
    return stage_per_call(record, "device_dispatch")
