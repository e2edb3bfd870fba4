"""Seconds of the port's ``render_wait`` stage per render request in the mel cell: what a worker waits for
its panels (queue, dispatch, device, readback and unpack)."""

from harness.readers import stage_per_call


def read(record: dict) -> float | None:
    return stage_per_call(record, "render_wait")
