"""Seconds of the port's ``wav_load`` stage (the audio CLI's WAV read and mix to float32) per mel figure."""

from harness.soundscape import stage_per_figure


def read(record: dict) -> float | None:
    return stage_per_figure(record, "wav_load")
