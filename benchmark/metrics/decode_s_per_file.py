"""Seconds of the port's ``cdf_decode`` stage (every uncached CDF decode: pre-pass, render and regathers, threads summed) per file of the pass."""


def read(record: dict) -> float | None:
    timer = record["outcome"].get("timer")
    files = sum(p["files"] for p in record["outcome"].get("passes") or [])
    if timer is None or not timer.counts.get("cdf_decode") or not files:
        return None
    return timer.totals["cdf_decode"] / files
