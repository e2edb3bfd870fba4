"""Seconds of the port's ``prepass_tracker`` stage (the exact tracker's adds and percentile reads) per file of the pass.

A tracker's regather decodes a file again inside this stage; that decode
also counts under ``cdf_decode`` (``decode_s_per_file``).
"""


def read(record: dict) -> float | None:
    timer = record["outcome"].get("timer")
    files = sum(p["files"] for p in record["outcome"].get("passes") or [])
    if timer is None or not timer.counts.get("prepass_tracker") or not files:
        return None
    return timer.totals["prepass_tracker"] / files
