"""Seconds of the port's ``png_encode`` stage per encoded figure in the mel cell (worker threads summed)."""

from harness.readers import stage_per_call


def read(record: dict) -> float | None:
    return stage_per_call(record, "png_encode")
