"""The percentile-quantize kernel's share of the HBM roofline in the mel cell: its launches' matrix read and
indices written at 3.35 TB/s over its device time."""

from harness.soundscape import percentile_quantize_share


def read(record: dict) -> float | None:
    return percentile_quantize_share(record)
