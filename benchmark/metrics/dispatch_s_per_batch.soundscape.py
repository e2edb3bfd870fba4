"""Seconds of the port's ``device_dispatch`` stage per dispatched batch in the mel cell: the host's enqueue
of a device render, on the coalescer's dispatcher."""

from harness.readers import stage_per_call


def read(record: dict) -> float | None:
    return stage_per_call(record, "device_dispatch")
