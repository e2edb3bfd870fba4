"""The 5 s cell's figure time in the traced run: the window's seconds over the figures it finished."""


def read(record: dict) -> float | None:
    return record["outcome"].get("e2e", {}).get("audio_figure_s")
