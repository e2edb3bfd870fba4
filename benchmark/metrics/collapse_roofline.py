"""The collapse kernel's share of the HBM roofline: its launches' needed bytes at 3.35 TB/s over its device time."""

from harness.readers import kernel_roofline


def read(record: dict) -> float | None:
    return kernel_roofline(record, "collapse")
