"""The readers of the port's stages: seconds per file, figure, request or batch from the traced run's stage timer."""

from __future__ import annotations

import pytest
from bench_helpers import BENCH

PER_FILE = {"decode_s_per_file": "cdf_decode", "prepass_stats_s_per_file": "prepass_stats",
            "prepass_host_collapse_s_per_file": "prepass_host_collapse",
            "prepass_tracker_s_per_file": "prepass_tracker"}
PER_FIGURE = {"wav_load_s_per_figure": "wav_load"}
PER_CALL = {"render_queue_wait_s_per_request": "render_queue_wait", "dispatch_s_per_batch.archive": "device_dispatch",
            "dispatch_s_per_batch.audio": "device_dispatch", "render_wait_s_per_request.archive": "render_wait",
            "render_wait_s_per_request.audio": "render_wait", "dispatch_s_per_batch.soundscape": "device_dispatch",
            "render_wait_s_per_request.soundscape": "render_wait", "png_encode_s_per_figure.soundscape": "png_encode"}
STAGES = sorted({*PER_FILE.values(), *PER_FIGURE.values(), *PER_CALL.values()})


def _record(stages: list[str]) -> dict:
    """Two passes of 16 and 4 files; each stage given 3.0 s over 6 calls, and 8 composites."""
    from configurable_spectrograms_torch.utils.timing import StageTimer

    timer = StageTimer("synthetic")
    for stage in stages:
        for k in range(6):
            timer.add(stage, 0.5, 100.0 + k)
    for _ in range(8):
        timer.add("composite", 0.01)
    outcome = {"timer": timer, "passes": [{"files": 16}, {"files": 4}]}
    return {"recorder": None, "outcome": outcome, "device": None}


def _read(metric: str, record: dict):
    import run

    return run.load_module(BENCH / "metrics" / f"{metric}.py").read(record)


@pytest.mark.parametrize("metric", sorted({**PER_FILE, **PER_FIGURE, **PER_CALL}))
def test_stage_reader_divides_its_stage_and_reads_nothing_without_it(metric):
    stage = {**PER_FILE, **PER_FIGURE, **PER_CALL}[metric]
    want = 3.0 / 20 if metric in PER_FILE else 3.0 / 8 if metric in PER_FIGURE else 0.5
    assert _read(metric, _record(STAGES)) == pytest.approx(want)
    assert _read(metric, _record([s for s in STAGES if s != stage])) is None
