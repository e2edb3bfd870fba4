"""The mel cell (``audio_soundscape_mel.birdclef_10min``) at a tiny size: its driver, control, faults and readers.

On the CPU the port runs its plain kernels; the driver's run is correct,
its control (the mel power in bfloat16) is not, and a run whose mel path
is broken underneath is not either.  The readers divide the port's new
stages by the window's figures and count the percentile-quantize kernel's
bytes by ``chip_smoke.py``'s rule.  On the card (``-m cuda``) a tiny traced
run reads every metric the cell lists.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
from bench_helpers import BENCH, ROOT, run_cell, traffic

import control

CELL = "audio_soundscape_mel.birdclef_10min"


def _failed(got: dict) -> set[str]:
    return {name for name, c in got["checks"].items()
            if not (c["value"] <= c["limit"] if c["rule"] == "at_most" else c["value"] >= c["limit"])}


def test_driver_is_correct_on_the_cpu():
    printed = []
    code, result = run_cell(CELL, seconds=0.5, sample_figures=2, lines=printed)
    assert code == 0 and result is not None
    c = {k: v["value"] for k, v in result["checks"].items()}
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 2, result["checks"]
    assert c["mel_err_ratio"] < 0.05 and c["mel_centres_rel_err"] < 1e-7 and c["figures_rows_compared"] >= 1
    assert c["figures_judged"] == 2 and c["tile_pixels_off_pct"] < 0.05 and c["tile_max_bins_off"] <= 1
    assert set(result["metrics"]) == {"setup_s", "audio_figure_s", "peak_rss_gib"}
    window = json.loads(next(line for line in printed if line.startswith("[window] "))[len("[window] "):])
    assert window["figures"] == result["attempted"]
    assert result["metrics"]["audio_figure_s"]["value"] == window["seconds"] / window["figures"]


@pytest.mark.parametrize("seed", [5, 3000000007])
def test_control_is_not_correct(seed):
    got = control.control(CELL, seed, traffic(CELL, seconds=12))
    assert got["correct"] is False
    assert {"mel_err_ratio", "mel_centres_rel_err", "tile_pixels_off_pct"} <= _failed(got), got


def _filterbank_shifted_one_bin(monkeypatch):
    from configurable_spectrograms_torch.ops import stft

    real = stft.mel_filterbank

    def shifted(*a, **k):
        weights, centres = real(*a, **k)
        return np.roll(weights, 1, axis=0), centres

    monkeypatch.setattr(stft, "mel_filterbank", shifted)


def _linear_bins_on_the_y_axis(monkeypatch):
    from configurable_spectrograms_torch.cli import audio

    real = audio.audio_spectrogram_dataset

    def linear(signal, rate, *a, **k):
        ds = real(signal, rate, *a, **k)
        ds["y"] = np.linspace(0.0, rate / 2.0, ds["y"].size).astype(np.float32)
        return ds

    monkeypatch.setattr(audio, "audio_spectrogram_dataset", linear)


@pytest.mark.parametrize("fault, caught_by", [(_filterbank_shifted_one_bin, "mel_err_ratio"),
                                              (_linear_bins_on_the_y_axis, "mel_centres_rel_err")])
def test_mel_fault_is_not_correct(monkeypatch, fault, caught_by):
    fault(monkeypatch)
    code, result = run_cell(CELL, seconds=0.5, sample_figures=2)
    assert code == 0 and result is not None
    assert result["correct"] is False, result["checks"]
    assert caught_by in _failed(result), result["checks"]


def _read(metric: str, record: dict):
    import run

    return run.load_module(BENCH / "metrics" / f"{metric}.py").read(record)


@pytest.mark.parametrize("metric, stage", [("mel_filterbank_s_per_figure", "mel_filterbank"),
                                           ("mel_project_s_per_figure", "mel_project"),
                                           ("spectrogram_readback_s_per_figure", "spectrogram_readback")])
def test_stage_reader_divides_by_the_figures(metric, stage):
    from configurable_spectrograms_torch.utils.timing import StageTimer

    timer = StageTimer("synthetic")
    for k in range(6):
        timer.add(stage, 0.5, 100.0 + k)
    assert _read(metric, {"recorder": None, "outcome": {"timer": timer, "attempted": 4}, "device": None}) == 0.75
    assert _read(metric, {"recorder": None, "outcome": {"timer": StageTimer("empty"), "attempted": 4},
                          "device": None}) is None


def _mel_record() -> dict:
    """A traced mel window of 4 figures: each of the port's stages 0.5 s a call, and the device busy 15% of 50 s."""
    from configurable_spectrograms_torch.utils.timing import StageTimer

    timer = StageTimer("synthetic")
    for stage in ("wav_load", "png_encode", "composite", "device_dispatch", "render_wait"):
        for k in range(4):
            timer.add(stage, 0.5, 100.0 + k)
    return {"recorder": None, "outcome": {"timer": timer, "attempted": 4},
            "device": {"busy_s": 7.5, "window_s": 50.0, "by_op": {}}}


SHARED_READERS = {"wav_load_s_per_figure": 0.5, "png_encode_s_per_figure.audio": 0.5,
                  "composite_s_per_figure.audio": 0.5, "dispatch_s_per_batch.audio": 0.5,
                  "render_wait_s_per_request.audio": 0.5, "device_idle_share.audio": 85.0}


@pytest.mark.parametrize("metric", sorted(SHARED_READERS))
def test_shared_audio_reader_reads_the_mel_cell(metric):
    """Each of the 5 s cell's stage readers has a ``.soundscape`` twin in the mel cell that moves its figure time.

    The 5 s cell reports no ``audio_figure_s`` (its runs spread too widely for the bound), so the two
    cells' readers of one stage are split by the end-to-end metric they move; both read the same.
    """
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    twin = metric.removesuffix(".audio") + ".soundscape"
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert entries[metric]["workloads"] == ["audio_wav.clips_5s"] and entries[metric]["moves"] == "peak_rss_gib"
    assert entries[twin]["workloads"] == [CELL] and entries[twin]["moves"] == "audio_figure_s"
    assert _read(twin, _mel_record()) == pytest.approx(SHARED_READERS[metric])
    assert _read(metric, _mel_record()) == pytest.approx(SHARED_READERS[metric])


def test_clip_figure_reader_reads_the_traced_window_and_nothing_without_it():
    """The 5 s cell's figure time, per layer: the window's seconds over its figures, from the traced run."""
    assert _read("clip_figure_s", {"recorder": None, "outcome": {"e2e": {"audio_figure_s": 0.0175}},
                                   "device": None}) == 0.0175
    assert _read("clip_figure_s", {"recorder": None, "outcome": {"e2e": {}}, "device": None}) is None


def test_figure_reader_and_the_roofline():
    from harness import roofline, soundscape
    from harness.trace import Recorder

    rec = Recorder()
    rec.spans += [("figure", 1.0, 1.25), ("figure", 2.0, 2.5), ("other", 0.0, 9.0)]
    assert _read("soundscape_figure_s", {"recorder": rec, "outcome": {}, "device": None}) == pytest.approx(0.375)
    shape = (1, 60160, 64)
    assert soundscape.percentile_quantize_bytes(shape) == 60160 * 64 * 5
    seconds = 2 * soundscape.percentile_quantize_bytes(shape) / roofline.PEAKS["hbm_bytes_per_s"]
    record = {"outcome": {"launch_shapes": {"percentile_quantize": [shape, shape]}},
              "device": {"by_op": {"cst_percentile_quantize_kernel(PqArgs)": 4 * seconds, "cst_collapse_kernel": 1.0}}}
    assert _read("percentile_quantize_roofline.soundscape", record) == pytest.approx(25.0)
    record["outcome"] = {}
    assert _read("percentile_quantize_roofline.soundscape", record) is None


@pytest.mark.cuda
def test_tiny_traced_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code, result = run_cell(CELL, trace=1, cuda=True, seconds=0.5, sample_figures=2)
    assert code == 0 and result is not None and result["correct"], result
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(result["metrics"]) == {m["name"] for m in bench["per_layer"] if CELL in m["workloads"]}
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["percentile_quantize_roofline.soundscape"]["value"] <= 100
