"""Seconds of the port's ``prepass_stats`` stage (a chunk's stack and upload, collapse launch, counts and histogram back) per file of the pass."""


def read(record: dict) -> float | None:
    timer = record["outcome"].get("timer")
    files = sum(p["files"] for p in record["outcome"].get("passes") or [])
    if timer is None or not timer.counts.get("prepass_stats") or not files:
        return None
    return timer.totals["prepass_stats"] / files
