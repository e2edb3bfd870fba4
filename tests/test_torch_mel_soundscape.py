"""The port's mel path against the mel cell's plain reference (``benchmark/reference/mel.py``), on the CPU.

Seeded recordings of ``benchmark/gen/audio.py``, 4 s each, at a few
(rate, frame length, hop, mel bins), the first of them the cell's PANNs
widths at a low rate: the port's ``mel_spectrogram`` and
``audio_spectrogram_dataset(n_mels=...)`` within the cell's tolerance of
the float64 reference; the filterbank and the mel centres against the
reference's own formula; one CLI figure's tiles judged against the
reference's figure with the cell's limits; and the stages
``mel_filterbank``, ``mel_project`` and ``spectrogram_readback`` recorded
once or twice a figure with a stage timer on, and never with it off.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from gen import audio as gen_audio  # noqa: E402
from reference import audio as ref_audio  # noqa: E402
from reference import judge, layout  # noqa: E402
from reference import mel as ref_mel  # noqa: E402

from configurable_spectrograms_torch.ops import stft  # noqa: E402

torch.set_num_threads(1)

CELL = json.loads((BENCH / "workloads" / "audio_soundscape_mel.birdclef_10min.json").read_text())
LIMITS = CELL["traffic"]["limits"]
CASES = [(8000, 1024, 320, 64), (8000, 256, 80, 24), (16000, 512, 160, 40)]
SECONDS = 4.0


def _ids(case) -> str:
    return "rate{}-frame{}-hop{}-mels{}".format(*case)


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """One seeded WAV per rate: {rate: (path, float32 samples)}."""
    root = tmp_path_factory.mktemp("mel_soundscape")
    out = {}
    for i, rate in enumerate(sorted({c[0] for c in CASES})):
        path = str(root / f"r{rate}.wav")
        gen_audio.write_wav(path, gen_audio.recording(2147483659, i, SECONDS, rate), rate)
        sig, got_rate = ref_audio.load(path)
        assert got_rate == rate
        out[rate] = (path, sig)
    return out


@pytest.fixture
def device_path(monkeypatch):
    from configurable_spectrograms_torch.utils import timing

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    for name in ("CST_RENDER_COALESCE", "CST_HOST_COMPUTE_GATE", "CST_PROFILE_DIR"):
        monkeypatch.delenv(name, raising=False)
    yield timing
    timing.ACTIVE = None


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_mel_spectrogram_matches_the_reference(case, recordings):
    rate, frame, hop, n_mels = case
    _, sig = recordings[rate]
    got = stft.mel_spectrogram(torch.from_numpy(sig), rate, frame, hop, n_mels).numpy()
    want = ref_mel.mel_power(sig, rate, frame, hop, n_mels)
    assert got.shape == want.shape == (ref_mel.frame_starts(sig.size, frame, hop).size, n_mels)
    assert ref_audio.err_ratio(want, got) <= LIMITS["mel_err_ratio"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_audio_dataset_mel_matches_the_reference(case, recordings, device_path):
    rate, frame, hop, n_mels = case
    _, sig = recordings[rate]
    ds = stft.audio_spectrogram_dataset(sig, rate, frame, hop, n_mels=n_mels)
    want = ref_mel.mel_power(sig, rate, frame, hop, n_mels)
    assert ds["data"].shape == (want.shape[0], 1, n_mels)
    assert ref_audio.err_ratio(want, ds["data"][:, 0, :]) <= LIMITS["mel_err_ratio"]
    assert ref_mel.centres_rel_err(ref_mel.centres(n_mels, rate), ds["y"]) <= LIMITS["mel_centres_rel_err"]
    np.testing.assert_array_equal(ds["x"], (np.arange(want.shape[0]) * hop + frame / 2) / rate)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_filterbank_and_centres_match_the_formula(case):
    rate, frame, _, n_mels = case
    weights, centres = stft.mel_filterbank(n_mels, frame, float(rate))
    want = ref_mel.filterbank(n_mels, frame, rate).numpy()
    assert weights.shape == want.shape == (frame // 2 + 1, n_mels)
    assert np.abs(weights - want).max() <= 2.0**-23  # float32 of values in [0, 1]
    assert (want.max(axis=0) > 0).all()  # no empty band at these widths
    assert ref_mel.centres_rel_err(ref_mel.centres(n_mels, rate), centres) <= LIMITS["mel_centres_rel_err"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cli_figure_tiles_match_the_reference(case, recordings, device_path, tmp_path):
    from configurable_spectrograms_torch.cli.audio import render_audio_spectrogram

    rate, frame, hop, n_mels = case
    wav, sig = recordings[rate]
    png = str(tmp_path / "mel.png")
    assert render_audio_spectrogram(wav, png, frame_length=frame, hop_length=hop, n_mels=n_mels)
    text = layout.Text(str(BENCH.parent / layout.FONT))
    r = judge.judge(judge.decode(png), ref_mel.figure(sig, rate, frame, hop, n_mels), text)
    assert r["tiles_missing"] == 0 and r["compared"] > 0
    assert 100.0 * r["off"] / r["compared"] <= LIMITS["tile_pixels_off_pct"]
    assert r["max_gap"] <= LIMITS["tile_max_bins_off"]


@pytest.mark.parametrize("timer_on", [True, False], ids=["timer_on", "timer_off"])
def test_mel_stages_are_recorded_once_or_twice_a_figure(timer_on, recordings, device_path, tmp_path, monkeypatch):
    from configurable_spectrograms_torch.cli.audio import render_audio_spectrogram

    timing = device_path
    kept = []
    keep = timing.StageTimer._keep
    monkeypatch.setattr(timing.StageTimer, "_keep", lambda self, *a: (kept.append(a[0]), keep(self, *a)))
    timer = timing.ACTIVE = timing.StageTimer("test") if timer_on else None
    rate, frame, hop, n_mels = CASES[0]
    for k in range(2):
        assert render_audio_spectrogram(recordings[rate][0], str(tmp_path / f"{k}.png"), frame_length=frame,
                                        hop_length=hop, n_mels=n_mels)
    timing.ACTIVE = None
    mel = {"mel_filterbank", "mel_project", "spectrogram_readback"}
    if not timer_on:
        assert kept == []
        return
    assert {s: timer.counts.get(s) for s in mel} == {"mel_filterbank": 4, "mel_project": 2, "spectrogram_readback": 2}
    assert sum(1 for i in timer.intervals if i[0] in mel) == 8
