"""Seconds in the audio CLI's ``audio_spectrogram_dataset`` per figure (host arrays out: the device is done)."""


def read(record: dict) -> float | None:
    rec = record["recorder"]
    n = rec.count("stft")
    return rec.seconds("stft") / n if n else None
