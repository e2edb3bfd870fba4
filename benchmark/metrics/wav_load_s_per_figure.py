"""Seconds of the port's ``wav_load`` stage (the audio CLI's WAV read and mix to float32) per composited figure."""


def read(record: dict) -> float | None:
    timer = record["outcome"].get("timer")
    if timer is None or not timer.counts.get("wav_load") or not timer.counts.get("composite"):
        return None
    return timer.totals["wav_load"] / timer.counts["composite"]
