"""Share of the window's collapse-route buckets that ran the percentile-quantize kernel: its launches over
the device dispatches that did not take the fused kernel.  None where the port has no such kernel."""


def read(record: dict) -> float | None:
    log = record["outcome"].get("log") or {}
    launches = log.get("launches") or {}
    if "percentile_quantize" not in launches or "fused_quantize" not in launches:
        return None
    buckets = log.get("dispatches", 0) - launches["fused_quantize"]
    return launches["percentile_quantize"] / buckets if buckets > 0 else None
