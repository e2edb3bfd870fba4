"""Per cent of the mel cell's traced window in which no kernel, copy or set ran on the card."""

from harness.readers import idle_pct


def read(record: dict) -> float | None:
    return idle_pct(record)
