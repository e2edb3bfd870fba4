"""Seconds of the port's ``prepass_host_collapse`` stage (the pre-pass's host collapse of a file for the exact tracker) per file of the pass."""


def read(record: dict) -> float | None:
    timer = record["outcome"].get("timer")
    files = sum(p["files"] for p in record["outcome"].get("passes") or [])
    if timer is None or not timer.counts.get("prepass_host_collapse") or not files:
        return None
    return timer.totals["prepass_host_collapse"] / files
