"""Cube uploads per file: the device cube cache's misses plus the pre-pass's own uploads."""

from harness.readers import per_file


def read(record: dict) -> float | None:
    return per_file(record, "uploads")
