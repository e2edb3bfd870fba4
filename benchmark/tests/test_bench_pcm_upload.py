"""The mel cell's ``pcm_uploads_per_figure.soundscape`` reader: the ``pcm_upload`` stage's count over the figures."""

from bench_helpers import BENCH


def _read(record: dict):
    import run

    return run.load_module(BENCH / "metrics" / "pcm_uploads_per_figure.soundscape.py").read(record)


def test_stage_reader_divides_by_the_figures():
    from configurable_spectrograms_torch.utils.timing import StageTimer

    timer = StageTimer("synthetic")
    for k in range(6):
        timer.add("pcm_upload", 0.5, 100.0 + k)
        timer.add("wav_load", 0.5, 100.0 + k)
    assert _read({"recorder": None, "outcome": {"timer": timer, "attempted": 4}, "device": None}) == 1.5
    without = StageTimer("parent")
    without.add("wav_load", 0.5, 100.0)
    for timer in (without, StageTimer("empty"), None):
        assert _read({"recorder": None, "outcome": {"timer": timer, "attempted": 4}, "device": None}) is None
