"""Seconds in ``batch_directory.compute_global_extrema`` (every combo's call) per file of the pass."""

from harness.readers import per_file


def read(record: dict) -> float | None:
    return per_file(record, "prepass_s")
