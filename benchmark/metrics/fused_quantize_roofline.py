"""The fused quantize kernel's share of the HBM roofline (both launches' device time)."""

from harness.readers import kernel_roofline


def read(record: dict) -> float | None:
    return kernel_roofline(record, "fused_quantize")
