"""A run whose timed path is broken underneath comes out not correct (the port's CPU path, tiny cells).

The faults a cell can have: an answer altered where it is produced (a
colour index, a pitch sum, a power value), half of the batch left out, and
a step that returns its state unchanged (the pre-pass writes no extrema; the
STFT hands back the last recording's spectrogram), and the given extrema
ignored by the figures named after them.
"""

from __future__ import annotations

import pytest
from bench_helpers import run_cell


def _fused_index_altered(monkeypatch):
    from configurable_spectrograms_torch.render import dispatch

    real = dispatch.fused_quantize_lanes

    def altered(*a, **k):
        out = real(*a, **k)
        out["idx"] = (out["idx"].int() + 3).clamp(max=255).to(out["idx"].dtype)
        return out

    monkeypatch.setattr(dispatch, "fused_quantize_lanes", altered)


def _pitch_sums_altered(monkeypatch):
    from configurable_spectrograms_torch.render import dispatch

    real = dispatch.collapse_lanes
    monkeypatch.setattr(dispatch, "collapse_lanes", lambda *a, **k: real(*a, **k).roll(3, dims=1))


def _half_the_batch_left_out(monkeypatch):
    from configurable_spectrograms_torch.fast import batch_directory

    real = batch_directory.FAST_process_single_orbit

    def half(orbit, files, frame, zoom, y_scale, z_scale, *rest):
        if z_scale == "log":
            return {"orbit": orbit, "status": "ok", "errors": []}
        return real(orbit, files, frame, zoom, y_scale, z_scale, *rest)

    monkeypatch.setattr(batch_directory, "FAST_process_single_orbit", half)


def _prepass_state_unchanged(monkeypatch):
    from configurable_spectrograms_torch.fast import batch_directory

    monkeypatch.setattr(batch_directory, "compute_global_extrema", lambda *a, **k: None)


def _given_extrema_ignored(monkeypatch):
    """Every given-extrema job renders as the job without extrema does."""
    from configurable_spectrograms_torch.fast import batch_directory

    real = batch_directory.FAST_process_single_orbit

    def ignored(orbit, files, frame, zoom, y_scale, z_scale, inst, cmap, out, t_orbit, t_inst, extrema, *rest):
        return real(orbit, files, frame, zoom, y_scale, z_scale, inst, cmap, out, t_orbit, t_inst, None, *rest)

    monkeypatch.setattr(batch_directory, "FAST_process_single_orbit", ignored)


@pytest.mark.parametrize("fault", [_fused_index_altered, _pitch_sums_altered, _half_the_batch_left_out,
                                   _prepass_state_unchanged, _given_extrema_ignored])
def test_flagship_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    code, result = run_cell("fast_esa_l2.sample_orbits")
    assert code == 0 and result is not None
    assert result["correct"] is False, result["checks"]


def _power_altered(monkeypatch):
    from configurable_spectrograms_torch.cli import audio

    real = audio.audio_spectrogram_dataset

    def altered(*a, **k):
        ds = real(*a, **k)
        ds["data"] = ds["data"] * 1.01
        return ds

    monkeypatch.setattr(audio, "audio_spectrogram_dataset", altered)


def _stft_state_unchanged(monkeypatch):
    from configurable_spectrograms_torch.cli import audio

    real, last = audio.audio_spectrogram_dataset, []

    def stale(*a, **k):
        if not last:
            last.append(real(*a, **k))
        return last[0]

    monkeypatch.setattr(audio, "audio_spectrogram_dataset", stale)


@pytest.mark.parametrize("fault", [_power_altered, _stft_state_unchanged])
def test_audio_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    code, result = run_cell("audio_wav.clips_5s", seconds=0.5, sample_figures=2)
    assert code == 0 and result is not None
    assert result["correct"] is False, result["checks"]
