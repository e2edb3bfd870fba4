"""Seconds of the driver's ``figure`` span (the CLI call, then a device synchronise) per figure."""


def read(record: dict) -> float | None:
    rec = record.get("recorder")
    n = rec.count("figure") if rec is not None else 0
    return rec.seconds("figure") / n if n else None
