"""Seconds of the port's ``mel_project`` stage (the enqueue of the projection on the filterbank) per figure."""

from harness.soundscape import stage_per_figure


def read(record: dict) -> float | None:
    return stage_per_figure(record, "mel_project")
