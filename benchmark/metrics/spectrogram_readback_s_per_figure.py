"""Seconds of the port's ``spectrogram_readback`` stage (the mel spectrogram's copy to the host, which waits
for the STFT and the projection) per figure."""

from harness.soundscape import stage_per_figure


def read(record: dict) -> float | None:
    return stage_per_figure(record, "spectrogram_readback")
