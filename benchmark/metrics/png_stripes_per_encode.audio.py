"""Row stripes per PNG encode: the port's ``png_stripe`` stages over its ``png_encode`` stages.

The native encoder splits one figure's deflate into row stripes and the
encode wrapper records one ``png_stripe`` stage a stripe; a program without
that stage (no stripes) reads None.
"""


def read(record: dict) -> float | None:
    timer = record["outcome"].get("timer")
    if timer is None or not timer.counts.get("png_stripe") or not timer.counts.get("png_encode"):
        return None
    return timer.counts["png_stripe"] / timer.counts["png_encode"]
