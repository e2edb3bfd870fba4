"""Seconds of the port's ``gate_wait`` stage (blocked on a compute-gate slot, worker threads summed) per composited figure."""


def read(record: dict) -> float | None:
    timer = record["outcome"].get("timer")
    if timer is None or not timer.counts.get("gate_wait") or not timer.counts.get("composite"):
        return None
    return timer.totals["gate_wait"] / timer.counts["composite"]
