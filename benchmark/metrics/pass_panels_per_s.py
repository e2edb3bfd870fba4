"""Panels of the window's whole passes over the window's seconds: the archive's rate, in the traced run."""


def read(record: dict) -> float | None:
    return record["outcome"].get("e2e", {}).get("archive_panels_per_s")
