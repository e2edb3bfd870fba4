"""Panels of the window's passes over the passes' seconds less their extrema pre-pass."""


def read(record: dict) -> float | None:
    passes = record["outcome"].get("passes") or []
    seconds = sum(p["seconds"] - p["prepass_s"] for p in passes)
    return sum(p["panels"] for p in passes) / seconds if seconds > 0 else None
