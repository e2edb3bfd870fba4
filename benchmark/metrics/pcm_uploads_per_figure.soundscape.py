"""PCM uploads per mel figure: the port's ``pcm_upload`` stages over the window's figures.

The audio CLI sends a 16-bit mono WAV's int16 samples to the card and
widens them there, one ``pcm_upload`` stage a figure; a program without
that stage reads None.
"""


def read(record: dict) -> float | None:
    outcome = record["outcome"]
    timer, figures = outcome.get("timer"), outcome.get("attempted")
    if timer is None or not figures or not timer.counts.get("pcm_upload"):
        return None
    return timer.counts["pcm_upload"] / figures
