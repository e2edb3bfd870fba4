"""The numbers a run compares with the reference, each with its limit and which way it binds."""

from __future__ import annotations


def at_most(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": value, "limit": limit, "rule": "at_most", "ok": value <= limit}


def at_least(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": value, "limit": limit, "rule": "at_least", "ok": value >= limit}
