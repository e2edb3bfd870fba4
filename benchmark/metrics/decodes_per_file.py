"""The port's dataset-cache misses (CDF decodes) per file of the pass."""

from harness.readers import per_file


def read(record: dict) -> float | None:
    return per_file(record, "decodes")
