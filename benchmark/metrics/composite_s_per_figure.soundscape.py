"""Seconds of the port's ``composite`` stage per composited figure in the mel cell (worker threads summed)."""

from harness.readers import stage_per_call


def read(record: dict) -> float | None:
    return stage_per_call(record, "composite")
