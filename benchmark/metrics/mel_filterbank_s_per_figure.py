"""Seconds of the port's ``mel_filterbank`` stage per figure: two builds of the weights, the second with its
upload, which waits for the STFT queued before it."""

from harness.soundscape import stage_per_figure


def read(record: dict) -> float | None:
    return stage_per_figure(record, "mel_filterbank")
