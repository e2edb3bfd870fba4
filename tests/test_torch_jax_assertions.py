"""The JAX package's own assertions, made on the port, on the JAX tests' own inputs.

Each test here is a JAX test that cannot run against the port (it imports
``jax``, reaches ``render.link`` or a private of the JAX package): the same
seeds, shapes and parametrisations, the same assertions and tolerances,
and the same independent reference -- numpy, ``tests/oracle.py``,
matplotlib (skipped where it is not installed, as the JAX tests skip),
PIL or the goldens -- with the port's function and tensors in place of the
JAX package's.  Each docstring names the JAX test, and
``tests/test_torch_jax_suite.py``'s ``NOT_APPLICABLE`` names the test here
that holds it.  Where the port's design has no counterpart of a JAX
test's machinery (the relay's watchdogs, XLA's virtual devices), the
docstring says which of its assertions the port can carry, and how.

This module imports neither ``jax`` nor the JAX package (a test below
proves it), so it runs on the card as it runs here:
``CST_TORCH_DEVICE`` names the device (the CPU when it is unset), and
tensors go there, so on a card the wrappers of ``ops/kernels.py`` launch
the CUDA kernels and are held to these references.  The tests of the
parallel layer run their ranks on the CPU (Gloo), as
``tests/test_torch_parallel.py`` does.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from configurable_spectrograms_torch.ops import kernels as K
from configurable_spectrograms_torch.ops import spectrogram as S
from configurable_spectrograms_torch.ops import stft as tstft
from configurable_spectrograms_torch.ops._colormap_data import colormap_lut
from configurable_spectrograms_torch.render import device_cache, dispatch, drain, fastpng, service
from configurable_spectrograms_torch.render.host_quantize import host_quantize
from configurable_spectrograms_torch.render.panel import PanelData
from configurable_spectrograms_torch.render.tile import TimeWindow, compute_time_window, make_x_map, resample_indices

REPO = Path(__file__).resolve().parents[1]
GOLDEN_DIR = REPO / "tests" / "goldens"

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_device(monkeypatch):
    """The device of ``CST_TORCH_DEVICE`` (the CPU when unset), the device backend, a fresh cube cache."""
    monkeypatch.setenv("CST_TORCH_DEVICE", os.environ.get("CST_TORCH_DEVICE", "cpu"))
    monkeypatch.delenv("CST_RENDER_BACKEND", raising=False)
    device_cache.clear_cube_caches()
    yield
    device_cache.clear_cube_caches()


@pytest.fixture
def dev() -> torch.device:
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    return get_device()


@pytest.fixture
def rng():
    """tests/conftest.py's ``rng``: the same stream in every test."""
    return np.random.default_rng(1234)


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# tests/test_stft.py
# ---------------------------------------------------------------------------


def test_frame_signal(dev):
    """test_stft.py::test_frame_signal"""
    x = torch.arange(10, dtype=torch.float32, device=dev)
    frames = _np(tstft.frame_signal(x, 4, 2))
    assert frames.shape == (4, 4)
    np.testing.assert_array_equal(frames[0], [0, 1, 2, 3])
    np.testing.assert_array_equal(frames[1], [2, 3, 4, 5])


def test_stft_pure_tone_peak(dev):
    """test_stft.py::test_stft_pure_tone_peak"""
    rate, n = 8000, 8000
    freq = 1000.0
    t = np.arange(n) / rate
    sig = np.sin(2 * np.pi * freq * t).astype(np.float32)
    mag = _np(tstft.stft_magnitude(torch.from_numpy(sig).to(dev), frame_length=512, hop_length=128, power=2.0))
    assert mag.shape[1] == 257
    peak_bin = mag.mean(axis=0).argmax()
    peak_freq = peak_bin * rate / 512
    assert abs(peak_freq - freq) < rate / 512  # within one bin


def test_stft_matches_numpy(dev):
    """test_stft.py::test_stft_matches_numpy"""
    rng = np.random.default_rng(3)
    sig = rng.normal(size=2048).astype(np.float32)
    L, H = 256, 64
    got = _np(tstft.stft_magnitude(torch.from_numpy(sig).to(dev), L, H, power=1.0))
    w = tstft.hann_window(L)
    for f in [0, 5, got.shape[0] - 1]:
        seg = sig[f * H: f * H + L] * w
        ref = np.abs(np.fft.rfft(seg))
        np.testing.assert_allclose(got[f], ref, rtol=1e-4, atol=1e-4)


def test_mel_scale_roundtrip():
    """test_stft.py::test_mel_scale_roundtrip"""
    f = np.array([0.0, 440.0, 8000.0])
    np.testing.assert_allclose(tstft.mel_to_hz(tstft.hz_to_mel(f)), f, rtol=1e-9)


def test_mel_filterbank_shapes_and_coverage():
    """test_stft.py::test_mel_filterbank_shapes_and_coverage"""
    w, centers = tstft.mel_filterbank(40, 512, 16000.0)
    assert w.shape == (257, 40)
    assert centers.shape == (40,)
    assert np.all(np.diff(centers) > 0)
    assert w.sum() > 0 and np.all(w >= 0)


def test_mel_spectrogram_shape_and_energy(dev):
    """test_stft.py::test_mel_spectrogram_shape_and_energy: a 440 Hz tone peaks in the mel band that holds it."""
    rate = 16000
    t = np.arange(rate) / rate
    sig = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    mel = _np(tstft.mel_spectrogram(torch.from_numpy(sig).to(dev), rate, frame_length=512, hop_length=256, n_mels=40))
    assert mel.shape[1] == 40
    _, centers = tstft.mel_filterbank(40, 512, rate)
    peak_center = centers[mel.mean(axis=0).argmax()]
    assert 300 < peak_center < 650  # band containing 440 Hz


def test_audio_dataset_renders(tmp_path):
    """test_stft.py::test_audio_dataset_renders (the default, device backend)."""
    from configurable_spectrograms_torch.render.plotting import generic_plot_spectrogram_set

    rate = 8000
    t = np.arange(rate // 2) / rate
    sig = np.sin(2 * np.pi * (500 + 1500 * t) * t).astype(np.float32)  # chirp
    ds = tstft.audio_spectrogram_dataset(sig, rate, frame_length=256, hop_length=128)
    assert ds["data"].shape[1] == 1  # singleton collapse axis
    fig, _ = generic_plot_spectrogram_set(
        [ds], x_is_unix=False, z_scale="log", colormap="magma",
        y_min=float(ds["y"][0]), y_max=float(ds["y"][-1]),
    )
    assert fig is not None
    out = tmp_path / "audio.png"
    fig.savefig(str(out), dpi=50)
    assert out.exists()


def test_wav_cli_roundtrip(tmp_path):
    """test_stft.py::test_wav_cli_roundtrip, through the port's audio CLI module."""
    import wave

    from configurable_spectrograms_torch.cli import audio as cli

    rate = 8000
    t = np.arange(rate) / rate
    sig = (np.sin(2 * np.pi * 660 * t) * 0.5 * 32767).astype(np.int16)
    wav = str(tmp_path / "tone.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(sig.tobytes())
    loaded, r = cli.load_wav(wav)
    assert r == rate and abs(loaded).max() <= 0.5 + 1e-3
    out = str(tmp_path / "tone.png")
    assert cli.render_audio_spectrogram(wav, out, n_mels=32)
    assert Image.open(out).size[0] > 0


def test_stft_matmul_matches_fft(dev):
    """test_stft.py::test_stft_matmul_matches_fft"""
    rng = np.random.default_rng(7)
    sig = torch.from_numpy(rng.normal(size=4096).astype(np.float32)).to(dev)
    for L, H in ((256, 64), (512, 128)):
        for power in (1.0, 2.0):
            a = _np(tstft.stft_magnitude(sig, L, H, power=power, method="fft"))
            b = _np(tstft.stft_magnitude(sig, L, H, power=power, method="matmul"))
            assert a.shape == b.shape
            scale = np.abs(a).max()
            np.testing.assert_allclose(a, b, atol=5e-4 * scale, rtol=1e-3)


def test_stft_unknown_method_raises(dev):
    """test_stft.py::test_stft_unknown_method_raises"""
    with pytest.raises(ValueError, match="unknown stft method"):
        tstft.stft_magnitude(torch.zeros(512, device=dev), 256, 64, method="welch")


def test_mel_spectrogram_method_passthrough(dev):
    """test_stft.py::test_mel_spectrogram_method_passthrough"""
    rng = np.random.default_rng(11)
    sig = torch.from_numpy(rng.normal(size=4096).astype(np.float32)).to(dev)
    a = _np(tstft.mel_spectrogram(sig, 16000, 256, 64, n_mels=32, method="fft"))
    b = _np(tstft.mel_spectrogram(sig, 16000, 256, 64, n_mels=32, method="matmul"))
    scale = np.abs(a).max()
    np.testing.assert_allclose(a, b, atol=5e-4 * scale, rtol=1e-3)


def test_host_stft_matches_device(rng, dev):
    """test_stft.py::test_host_stft_matches_device"""
    sig = rng.normal(size=8000).astype(np.float32)
    device = _np(tstft.stft_magnitude(torch.from_numpy(sig).to(dev), 512, 128, 2.0, "fft"))
    host = tstft.host_stft_magnitude(sig, 512, 128, 2.0)
    assert device.shape == host.shape
    np.testing.assert_allclose(host, device, rtol=2e-4, atol=1e-3)
    weights, _ = tstft.mel_filterbank(24, 512, 8000.0)
    np.testing.assert_allclose(host @ weights, device @ weights, rtol=2e-4, atol=1e-3)


def test_audio_dataset_host_fallback(rng, monkeypatch):
    """test_stft.py::test_audio_dataset_host_fallback: ``CST_RENDER_BACKEND=host`` computes the STFT in numpy, once."""
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    calls = {"n": 0}
    orig = tstft.host_stft_magnitude

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tstft, "host_stft_magnitude", counting)
    sig = rng.normal(size=4000).astype(np.float32)
    ds = tstft.audio_spectrogram_dataset(sig, 8000, frame_length=256, hop_length=128, n_mels=16)
    assert calls["n"] == 1
    assert ds["data"].shape[2] == 16 and ds["data"].shape[1] == 1


def test_audio_dataset_rejects_bad_method_on_both_backends(rng, monkeypatch):
    """test_stft.py::test_audio_dataset_rejects_bad_method_on_both_backends"""
    sig = rng.normal(size=1000).astype(np.float32)
    for mode in ("host", "device"):
        monkeypatch.setenv("CST_RENDER_BACKEND", mode)
        with pytest.raises(ValueError, match="unknown stft method"):
            tstft.audio_spectrogram_dataset(sig, 8000, method="bogus")


def test_audio_dataset_hung_device_falls_back(rng, monkeypatch):
    """test_stft.py::test_audio_dataset_hung_device_falls_back.

    The JAX package abandons a hung device STFT after
    ``CST_DEVICE_DISPATCH_TIMEOUT`` and falls back to the numpy STFT.  The
    port has no timeout and no fallback (ROADMAP rule 5): a device error
    raises, and ``CST_RENDER_BACKEND=host`` is how a caller asks for the
    numpy STFT.  The JAX test's reference assertion holds on that path:
    the dataset is ``host_stft_magnitude`` of the signal, bit for bit.
    """
    sig = rng.normal(size=2000).astype(np.float32)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: the device STFT failed")

    with monkeypatch.context() as m:
        m.setattr(tstft, "stft_magnitude", broken)
        with pytest.raises(RuntimeError, match="device STFT failed"):
            tstft.audio_spectrogram_dataset(sig, 8000, frame_length=256, hop_length=128)
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    ds = tstft.audio_spectrogram_dataset(sig, 8000, frame_length=256, hop_length=128)
    expected = tstft.host_stft_magnitude(sig, 256, 128, 2.0)
    np.testing.assert_array_equal(ds["data"][:, 0, :], expected)


def test_pallas_stft_matches_matmul(rng, monkeypatch, dev):
    """test_stft.py::test_pallas_stft_matches_matmul: the ``pallas`` method's kernel
    (``ops.kernels.stft_power``; its CUDA kernel on a card) against the ``matmul`` method,
    and the kernel's wrapper must have run for each frame length."""
    calls = {"n": 0}
    real = K.stft_power

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(K, "stft_power", counting)
    x = torch.from_numpy(rng.standard_normal(44100).astype(np.float32)).to(dev)
    for L, hop in ((1024, 256), (512, 160)):
        a = _np(tstft.stft_magnitude(x, L, hop, 2.0, "matmul"))
        b = _np(tstft.stft_magnitude(x, L, hop, 2.0, "pallas"))
        assert a.shape == b.shape
        scale = np.maximum(np.abs(a), 1e-3 * np.abs(a).max())
        assert np.all(np.abs(a - b) <= 1e-4 * scale + 1e-2)
    assert calls["n"] == 2, "the pallas method did not reach the kernel's wrapper"


def test_pallas_stft_magnitude_power_one(rng, dev):
    """test_stft.py::test_pallas_stft_magnitude_power_one"""
    x = torch.from_numpy(rng.standard_normal(8192).astype(np.float32)).to(dev)
    a = _np(tstft.stft_magnitude(x, 1024, 512, 1.0, "matmul"))
    b = _np(tstft.stft_magnitude(x, 1024, 512, 1.0, "pallas"))
    assert np.allclose(a, b, rtol=1e-3, atol=1e-3)


def test_dataset_accepts_pallas_method(rng):
    """test_stft.py::test_dataset_accepts_pallas_method"""
    sig = rng.standard_normal(22050).astype(np.float32)
    ds = tstft.audio_spectrogram_dataset(sig, 22050, frame_length=512, hop_length=256, method="pallas")
    assert ds["data"].shape[1] == 1 and ds["data"].shape[2] == 257


# ---------------------------------------------------------------------------
# tests/test_native_blit.py: the port's native blit and blend (it has no
# fallback encoder, so nothing skips for want of a toolchain)
# ---------------------------------------------------------------------------


def _numpy_tail(monkeypatch):
    """Force resample_indices onto its numpy tail (the native blit declines)."""
    monkeypatch.setattr(fastpng, "blit_runs", lambda *a: False)


def _random_case(rng, T=70, E=24, H=52, W=96):
    idx = rng.integers(0, 256, (T, E), dtype=np.uint8)
    kept_pos = np.sort(rng.choice(E, size=E - 4, replace=False)).astype(np.int32)
    n_kept = int(rng.integers(1, len(kept_pos) + 1))
    window = TimeWindow(t_start=6, t_count=T - 12, extent=(6.0, float(T - 7)), xlim=(0.0, float(T)))
    return dict(
        idx=idx, kept_pos=kept_pos, n_kept=n_kept, flip=bool(rng.integers(0, 2)), y0=3.5, y1=18000.0,
        t_start=window.t_start, t_count=window.t_count, x_map=make_x_map(window, W), out_h=H, out_w=W,
        y_scale="log" if rng.integers(0, 2) else "linear", lut=colormap_lut("viridis"),
    )


def _counting_blit(monkeypatch) -> dict:
    calls = {"n": 0}
    real = fastpng.blit_runs

    def counting(*a):
        calls["n"] += 1
        return real(*a)

    monkeypatch.setattr(fastpng, "blit_runs", counting)
    return calls


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_blit_matches_numpy_tail(monkeypatch, seed):
    """test_native_blit.py::test_blit_matches_numpy_tail"""
    rng = np.random.default_rng(seed)
    args = _random_case(rng)
    with monkeypatch.context() as m:
        calls = _counting_blit(m)
        native = resample_indices(**args)
        assert calls["n"], "the native blit did not run"
    with monkeypatch.context() as m:
        _numpy_tail(m)
        ref = resample_indices(**args)
    np.testing.assert_array_equal(native, ref)


def test_blit_into_clipped_view(monkeypatch):
    """test_native_blit.py::test_blit_into_clipped_view"""
    rng = np.random.default_rng(7)
    args = _random_case(rng, H=40, W=80)
    canvas_a = np.full((64, 120, 4), 7, np.uint8)
    canvas_b = canvas_a.copy()
    resample_indices(**args, out=canvas_a[10:43, 5:77])  # 33 x 72 view
    with monkeypatch.context() as m:
        _numpy_tail(m)
        resample_indices(**args, out=canvas_b[10:43, 5:77])
    np.testing.assert_array_equal(canvas_a, canvas_b)
    assert (canvas_a[:10] == 7).all() and (canvas_a[43:] == 7).all()  # outside the view untouched


def test_blit_pre_gathered(monkeypatch):
    """test_native_blit.py::test_blit_pre_gathered"""
    rng = np.random.default_rng(11)
    W, E, H = 64, 16, 30
    idx = rng.integers(0, 256, (W, E), dtype=np.uint8)
    window = TimeWindow(t_start=0, t_count=40, extent=(0.0, 39.0), xlim=(0.0, 39.0))
    args = dict(
        idx=idx, kept_pos=np.arange(E, dtype=np.int32), n_kept=E, flip=True, y0=1.0, y1=100.0,
        t_start=window.t_start, t_count=window.t_count, x_map=make_x_map(window, W), out_h=H, out_w=W,
        y_scale="linear", lut=colormap_lut("inferno"), pre_gathered=True,
    )
    native = resample_indices(**args)
    with monkeypatch.context() as m:
        _numpy_tail(m)
        ref = resample_indices(**args)
    np.testing.assert_array_equal(native, ref)


def test_blit_falls_back_on_unsupported_layout():
    """test_native_blit.py::test_blit_falls_back_on_unsupported_layout: declined layouts return False."""
    t_idx = np.zeros(4, np.int32)
    rest = (
        np.ones(4, np.uint8),  # x_ok
        np.zeros(1, np.int32),  # sel
        np.zeros(1, np.int32),  # starts
        np.full(1, 4, np.int32),  # counts
        np.zeros((257, 4), np.uint8),  # lut_ext
    )
    out = np.zeros((4, 4, 4), np.uint8)
    assert fastpng.blit_runs(np.asfortranarray(np.zeros((8, 8), np.uint8)), t_idx, *rest, out) is False
    assert fastpng.blit_runs(np.zeros((8, 8), np.uint8)[::-1], t_idx, *rest, out) is False
    idx_c = np.zeros((8, 8), np.uint8)
    assert fastpng.blit_runs(idx_c, np.full(4, 8, np.int32), *rest, out) is False
    bad_sel = (rest[0], np.full(1, 8, np.int32)) + rest[2:]
    assert fastpng.blit_runs(idx_c, t_idx, *bad_sel, out) is False


def _pil_paste(canvas: np.ndarray, tile: np.ndarray, x: int, y: int) -> np.ndarray:
    img = Image.fromarray(canvas.copy(), "RGBA")
    t = Image.fromarray(tile, "RGBA")
    img.paste(t, (x, y), t)
    return np.asarray(img)


def test_blend_tile_exhaustive_triples():
    """test_native_blit.py::test_blend_tile_exhaustive_triples: every (mask, canvas, tile) byte triple as Pillow blends it."""
    m, v1, v2 = np.meshgrid(*(np.arange(256, dtype=np.uint8),) * 3, indexing="ij")
    h, w = 4096, 4096
    canvas = np.stack([v1, v1, v1, v1], axis=-1).reshape(h, w, 4).copy()
    tile = np.stack([v2, v2, v2, m], axis=-1).reshape(h, w, 4).copy()
    expected = _pil_paste(canvas, tile, 0, 0)
    got = canvas.copy()
    assert fastpng.blend_tile(got, tile, 0, 0)
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blend_tile_random_placement_and_clipping(seed):
    """test_native_blit.py::test_blend_tile_random_placement_and_clipping"""
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (64, 80, 4), np.uint8)
    for _ in range(40):
        th, tw = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        tile = rng.integers(0, 256, (th, tw, 4), np.uint8)
        x = int(rng.integers(-tw - 4, 80 + 4))
        y = int(rng.integers(-th - 4, 64 + 4))
        expected = _pil_paste(canvas, tile, x, y)
        assert fastpng.blend_tile(canvas, tile, x, y)
        np.testing.assert_array_equal(canvas, expected)


def test_blend_tile_into_strided_canvas_rows():
    """test_native_blit.py::test_blend_tile_into_strided_canvas_rows"""
    rng = np.random.default_rng(7)
    full = rng.integers(0, 256, (32, 48, 4), np.uint8)
    tile = rng.integers(0, 256, (8, 8, 4), np.uint8)
    view = full[:, 4:40]
    expected = _pil_paste(np.ascontiguousarray(view), tile, 3, 5)
    assert fastpng.blend_tile(view, tile, 3, 5)
    np.testing.assert_array_equal(view, expected)


def test_blend_tile_declines_bad_layouts():
    """test_native_blit.py::test_blend_tile_declines_bad_layouts (the port always has its blend)."""
    canvas = np.zeros((8, 8, 4), np.uint8)
    tile = np.zeros((2, 2, 4), np.uint8)
    assert fastpng.blend_route() == "native"
    assert not fastpng.blend_tile(canvas[::-1], tile, 0, 0)  # negative stride
    assert not fastpng.blend_tile(canvas.astype(np.int16), tile, 0, 0)
    assert not fastpng.blend_tile(canvas, tile[:, :, :3], 0, 0)
    assert not fastpng.blend_tile(canvas, tile[:, ::-1], 0, 0)  # non-contiguous tile


def test_blend_probe_validates_against_pillow():
    """test_native_blit.py::test_blend_probe_validates_against_pillow"""
    lib = fastpng.library()
    assert fastpng._blend_matches_pillow(lib.fastpng_blend_tile)

    def _noop_blend(*_args):  # claims success, writes nothing
        return 0

    assert not fastpng._blend_matches_pillow(_noop_blend)


@pytest.mark.parametrize("seed", [0, 1])
def test_canvas_blender_matches_blend_tile(seed):
    """test_native_blit.py::test_canvas_blender_matches_blend_tile"""
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (48, 72, 4), np.uint8)
    paste = fastpng.canvas_blender(canvas)
    assert paste is not None
    for _ in range(30):
        th, tw = int(rng.integers(1, 24)), int(rng.integers(1, 24))
        tile = rng.integers(0, 256, (th, tw, 4), np.uint8)
        x = int(rng.integers(-tw - 3, 72 + 3))
        y = int(rng.integers(-th - 3, 48 + 3))
        expected = _pil_paste(canvas, tile, x, y)
        assert paste(tile, x, y)
        np.testing.assert_array_equal(canvas, expected)
    tile = np.zeros((2, 2, 4), np.uint8)
    assert not paste(tile.astype(np.int16), 0, 0)
    assert not paste(tile[:, :, :3], 0, 0)
    assert not paste(tile[:, ::-1], 0, 0)  # non-contiguous


def test_canvas_blender_declines_bad_canvases():
    """test_native_blit.py::test_canvas_blender_declines_bad_canvases"""
    assert fastpng.canvas_blender(np.zeros((8, 8, 3), np.uint8)) is None  # 3-channel canvas
    assert fastpng.canvas_blender(np.zeros((8, 8, 4), np.int16)) is None
    good = np.zeros((8, 8, 4), np.uint8)
    assert fastpng.canvas_blender(good[::-1]) is None  # negative stride
    assert fastpng.canvas_blender(good) is not None


# ---------------------------------------------------------------------------
# tests/test_ops.py and tests/test_pallas.py: the collapse, the percentile,
# the tile against numpy, tests/oracle.py and matplotlib; the kernels
# against numpy's nansum chain
# ---------------------------------------------------------------------------


def _lane(a, dev, dtype=None) -> torch.Tensor:
    """A one-lane tensor on *dev*: the port's ops take a leading lane dimension."""
    t = torch.as_tensor(np.asarray(a))
    return (t if dtype is None else t.to(dtype)).unsqueeze(0).to(dev)


def test_collapse_cube_matches_nansum(rng, dev):
    """test_ops.py::test_collapse_cube_matches_nansum"""
    T, A, E = 17, 8, 10
    cube = rng.normal(size=(T, A, E)).astype(np.float32)
    cube[rng.random(cube.shape) < 0.2] = np.nan
    mask = rng.random(A) < 0.5
    expected = np.nansum(cube[:, mask, :], axis=1)
    got = _np(S.collapse_cube(torch.from_numpy(cube).to(dev), torch.from_numpy(mask).to(dev), T))
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_collapse_cube_empty_mask_and_padding(rng, dev):
    """test_ops.py::test_collapse_cube_empty_mask_and_padding"""
    T, A, E = 6, 4, 5
    cube = rng.normal(size=(T, A, E)).astype(np.float32)
    got = _np(S.collapse_cube(torch.from_numpy(cube).to(dev), torch.zeros(A, dtype=torch.bool, device=dev), 4))
    np.testing.assert_array_equal(got[:4], np.zeros((4, E)))  # nansum of empty selection is 0
    assert np.all(np.isnan(got[4:]))  # padding rows forced NaN


@pytest.mark.parametrize("q", [0.0, 1.0, 42.7, 50.0, 99.0, 100.0])
def test_masked_nanpercentile(rng, q, dev):
    """test_ops.py::test_masked_nanpercentile"""
    vals = rng.normal(size=(40, 13)).astype(np.float32) * 100
    nanmask = rng.random(vals.shape) < 0.25
    vals[nanmask] = np.nan
    valid = rng.random(vals.shape) < 0.7
    ref_vals = np.where(valid, vals, np.nan)
    expected = np.nanpercentile(ref_vals, q)
    got = float(S.masked_nanpercentile(_lane(vals, dev), _lane(valid, dev), q)[0])
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)


def _run_panel(matrix, energy, spec, dev, y_min=0.0, y_max=4000.0, window=None, z_min=None, z_max=None,
               cmap="viridis"):
    T, E = matrix.shape
    if window is None:
        window = TimeWindow(t_start=0, t_count=T, extent=(0.0, float(T - 1)), xlim=(0.0, float(T - 1)))
    x_map = make_x_map(window, spec.width)
    e_valid = (energy >= y_min) & (energy <= y_max)
    z_bounds = np.array([np.nan if z_min is None else z_min, np.nan if z_max is None else z_max], np.float32)
    out = S.render_matrix(
        _lane(matrix, dev), _lane(energy, dev), _lane(e_valid, dev),
        torch.tensor([T], device=dev), torch.tensor([window.t_start], device=dev),
        torch.tensor([window.t_count], device=dev), _lane(x_map, dev), _lane(z_bounds, dev),
        _lane(colormap_lut(cmap), dev), spec,
    )
    return {k: _np(v)[0] for k, v in out.items()}, x_map


def _assert_tile_matches_oracle(matrix, energy, spec, dev, **kw):
    from oracle import oracle_tile

    out, x_map = _run_panel(matrix, energy, spec, dev, **kw)
    window = kw.get("window")
    t_start = window.t_start if window else 0
    t_count = window.t_count if window else matrix.shape[0]
    exp_idx, vmin, vmax = oracle_tile(
        matrix, energy, kw.get("y_min", 0.0), kw.get("y_max", 4000.0), t_start, t_count, x_map, spec.height,
        spec.width, spec.y_scale, spec.z_scale, kw.get("z_min"), kw.get("z_max"), spec.low_percentile,
        spec.high_percentile,
    )
    if exp_idx is None:
        assert bool(out["empty"])
        return out
    assert not bool(out["empty"])
    lut = colormap_lut(kw.get("cmap", "viridis"))
    lut_ext = np.concatenate([lut, np.array([[255, 255, 255, 255]], np.uint8)], axis=0)
    expected_rgba = lut_ext[np.where(exp_idx < 0, 256, exp_idx)]
    # +/-1 LUT index of quantization slack from f32-vs-f64 normalize.
    exp_safe = np.where(exp_idx < 0, 256, exp_idx)
    got_rgba = out["rgba"]
    mism = np.any(got_rgba != expected_rgba, axis=-1)
    if mism.any():
        got_idx = np.full(mism.shape, -9, np.int32)
        for cand in range(257):
            hit = np.all(got_rgba == lut_ext[cand], axis=-1)
            got_idx[hit] = cand
        assert np.all(np.abs(got_idx[mism] - exp_safe[mism]) <= 1), (
            f"{mism.sum()} pixels differ by more than 1 LUT index"
        )
        assert mism.mean() < 0.02, f"too many quantization mismatches: {mism.mean():.4f}"
    np.testing.assert_allclose(out["vmin"], vmin, rtol=1e-5)
    np.testing.assert_allclose(out["vmax"], vmax, rtol=1e-5)
    return out


@pytest.mark.parametrize("y_scale,z_scale", [("linear", "linear"), ("linear", "log"), ("log", "linear"), ("log", "log")])
def test_render_matrix_parity_all_scales(rng, y_scale, z_scale, dev):
    """test_ops.py::test_render_matrix_parity_all_scales (against tests/oracle.py)"""
    T, E = 50, 24
    matrix = (rng.random((T, E)).astype(np.float32) * 900).astype(np.float32)
    matrix[rng.random(matrix.shape) < 0.05] = 0.0  # exercise log masking
    energy = np.geomspace(30000, 4, E).astype(np.float32)  # descending, forces flip
    spec = S.RenderSpec(height=64, width=96, y_scale=y_scale, z_scale=z_scale)
    _assert_tile_matches_oracle(matrix, energy, spec, dev)


def test_render_matrix_energy_range_and_explicit_bounds(rng, dev):
    """test_ops.py::test_render_matrix_energy_range_and_explicit_bounds"""
    T, E = 30, 16
    matrix = rng.random((T, E)).astype(np.float32) * 100
    energy = np.geomspace(8000, 10, E).astype(np.float32)
    spec = S.RenderSpec(height=40, width=50, y_scale="linear", z_scale="linear")
    _assert_tile_matches_oracle(matrix, energy, spec, dev, y_min=50.0, y_max=4000.0, z_min=10.0, z_max=60.0)


def test_render_matrix_zoom_window_with_margins(rng, dev):
    """test_ops.py::test_render_matrix_zoom_window_with_margins"""
    T, E = 80, 12
    matrix = rng.random((T, E)).astype(np.float32) * 10
    energy = np.linspace(100, 1200, E).astype(np.float32)
    x = np.linspace(1000.0, 1790.0, T)
    window = compute_time_window(x, center=1780.0, duration_seconds=100.0)
    assert window is not None and window.xlim[1] > window.extent[1]
    spec = S.RenderSpec(height=32, width=64)
    out = _assert_tile_matches_oracle(matrix, energy, spec, dev, window=window)
    assert np.all(out["rgba"][:, -1] == np.array([255, 255, 255, 255], np.uint8))  # background margin


def test_render_matrix_all_nan_column_and_empty(rng, dev):
    """test_ops.py::test_render_matrix_all_nan_column_and_empty"""
    T, E = 20, 8
    matrix = rng.random((T, E)).astype(np.float32)
    matrix[:, 3] = np.nan  # whole column NaN -> dropped
    energy = np.linspace(10, 800, E).astype(np.float32)
    spec = S.RenderSpec(height=16, width=16)
    out, _ = _run_panel(matrix, energy, spec, dev)
    assert int(out["n_kept"]) == E - 1
    out2, _ = _run_panel(matrix, energy, spec, dev, y_min=10000.0, y_max=20000.0)  # no energy in range
    assert bool(out2["empty"])
    assert np.all(out2["rgba"] == 255)


def test_render_matrix_matches_matplotlib_imshow(rng, dev):
    """test_ops.py::test_render_matrix_matches_matplotlib_imshow (skips without matplotlib, as the JAX test does)"""
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    T, E = 12, 7
    matrix = (rng.random((T, E)) * 100).astype(np.float32)
    energy = np.linspace(100, 700, E).astype(np.float32)
    H, W = 70, 120
    spec = S.RenderSpec(height=H, width=W, y_scale="linear", z_scale="linear")
    out, _ = _run_panel(matrix, energy, spec, dev, y_min=0, y_max=4000, z_min=0.0, z_max=100.0)

    fig = Figure(figsize=(W / 10, H / 10), dpi=10)
    FigureCanvasAgg(fig)
    ax = fig.add_axes((0, 0, 1, 1))
    ax.set_axis_off()
    ax.imshow(matrix.T, aspect="auto", origin="lower", extent=(0, T - 1, float(energy[0]), float(energy[-1])),
              cmap="viridis", vmin=0.0, vmax=100.0, interpolation="nearest")
    ax.set_xlim(0, T - 1)
    fig.canvas.draw()
    ref = np.asarray(fig.canvas.buffer_rgba()).copy()
    assert ref.shape == (H, W, 4)
    mismatch = np.any(ref != out["rgba"], axis=-1).mean()
    assert mismatch < 0.08, f"matplotlib cross-check mismatch fraction {mismatch:.4f}"


@pytest.mark.parametrize("z_scale", ["linear", "log"])
def test_render_matches_matplotlib_log_y(rng, z_scale, dev):
    """test_ops.py::test_render_matches_matplotlib_log_y (skips without matplotlib, as the JAX test does)"""
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.colors as mcolors
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    T, E = 10, 6
    matrix = (rng.random((T, E)) * 90 + 5).astype(np.float32)
    energy = np.geomspace(10, 5000, E).astype(np.float32)
    H, W = 80, 120
    spec = S.RenderSpec(height=H, width=W, y_scale="log", z_scale=z_scale)
    out, _ = _run_panel(matrix, energy, spec, dev, y_min=0, y_max=10000, z_min=5.0, z_max=95.0)

    fig = Figure(figsize=(W / 10, H / 10), dpi=10)
    FigureCanvasAgg(fig)
    ax = fig.add_axes((0, 0, 1, 1))
    ax.set_axis_off()
    kwargs = dict(aspect="auto", origin="lower", extent=(0, T - 1, float(energy[0]), float(energy[-1])),
                  cmap="viridis", interpolation="nearest")
    data = matrix.T
    if z_scale == "log":
        # The reference raises an explicit log vmin to the matrix's minimum positive value.
        safe_vmin = max(5.0, float(data[np.isfinite(data) & (data > 0)].min()))
        kwargs["norm"] = mcolors.LogNorm(vmin=safe_vmin, vmax=95.0)
    else:
        kwargs.update(vmin=5.0, vmax=95.0)
    ax.imshow(data, **kwargs)
    ax.set_yscale("log")
    ax.set_xlim(0, T - 1)
    ax.set_ylim(float(energy[0]), float(energy[-1]))
    fig.canvas.draw()
    ref = np.asarray(fig.canvas.buffer_rgba()).copy()
    mismatch = np.any(ref != out["rgba"], axis=-1).mean()
    assert mismatch < 0.09, f"log-y/{z_scale}-z mismatch fraction {mismatch:.4f}"


def test_render_matrix_fuzz_vs_oracle(dev):
    """test_ops.py::test_render_matrix_fuzz_vs_oracle: ten seeded configurations against tests/oracle.py."""
    fuzz = np.random.default_rng(99)
    for _trial in range(10):
        T = int(fuzz.integers(8, 70))
        E = int(fuzz.integers(4, 30))
        matrix = (fuzz.random((T, E)) * 10 ** fuzz.integers(1, 5)).astype(np.float32)
        if fuzz.random() < 0.5:
            matrix[fuzz.random(matrix.shape) < 0.1] = 0.0
        if fuzz.random() < 0.3:
            matrix[:, int(fuzz.integers(0, E))] = np.nan
        descending = fuzz.random() < 0.5
        energy = (np.geomspace(9000, 5, E) if descending else np.geomspace(5, 9000, E)).astype(np.float32)
        y_scale = "log" if fuzz.random() < 0.5 else "linear"
        z_scale = "log" if fuzz.random() < 0.5 else "linear"
        t0 = int(fuzz.integers(0, T // 2))
        tc = int(fuzz.integers(1, T - t0))
        window = TimeWindow(t0, tc, (float(t0), float(t0 + tc - 1)),
                            (float(t0) - fuzz.random() * 3, float(t0 + tc - 1) + fuzz.random() * 3))
        z_min = float(fuzz.random() * 5) if fuzz.random() < 0.3 else None
        z_max = float(50 + fuzz.random() * 100) if fuzz.random() < 0.3 else None
        spec = S.RenderSpec(height=int(fuzz.integers(8, 50)), width=int(fuzz.integers(8, 80)),
                            y_scale=y_scale, z_scale=z_scale)
        _assert_tile_matches_oracle(matrix, energy, spec, dev, window=window, y_min=0.0, y_max=8000.0,
                                    z_min=z_min, z_max=z_max)


def _nansum_chain(cube: np.ndarray, mask: np.ndarray, t_valid: int) -> np.ndarray:
    """numpy's nansum over the selected pitch bins, rows at or past *t_valid* NaN: the collapse's reference."""
    out = np.nansum(cube[:, mask, :], axis=1, dtype=np.float32)
    out[t_valid:] = np.nan
    return out


@pytest.mark.parametrize("tv", [512, 300, 0])
def test_collapse_cube_pallas_matches_jnp(rng, tv, dev):
    """test_pallas.py::test_collapse_cube_pallas_matches_jnp: the collapse kernel (its plain
    version on the CPU) bit for bit against numpy's nansum chain, NaN where both are NaN."""
    T, A, E = 512, 16, 128
    cube = rng.normal(size=(T, A, E)).astype(np.float32)
    cube[rng.random(cube.shape) < 0.15] = np.nan
    mask = rng.random(A) < 0.5
    before = K.LAUNCHES["collapse"]
    got_np = _np(S.collapse_cube(torch.from_numpy(cube).to(dev), torch.from_numpy(mask).to(dev), tv))
    assert K.LAUNCHES["collapse"] == before + (dev.type == "cuda")
    ref_np = _nansum_chain(cube, mask, tv)
    both_nan = np.isnan(ref_np) & np.isnan(got_np)
    np.testing.assert_array_equal(np.where(both_nan, 0, got_np), np.where(both_nan, 0, ref_np))


@pytest.mark.parametrize("z_scale", ["log", "linear"])
@pytest.mark.parametrize("window", [(0, 512), (60, 300)])
def test_fused_quantize_pallas_matches_jnp(rng, z_scale, window, dev):
    """test_pallas.py::test_fused_quantize_pallas_matches_jnp: the fused collapse + quantize kernel
    (its plain version on the CPU) bit for bit against the unfused chain -- numpy's nansum
    collapse, then the port's explicit-bounds analysis -- and its col_all_nan against numpy."""
    T, A, E = 512, 16, 128
    t_start, t_count = window
    cube = (rng.random((T, A, E)) * 1e4).astype(np.float32)
    cube[rng.random(cube.shape) < 0.1] = np.nan
    cube[5, 3, 7] = np.inf
    cube[6, 2, 9] = -np.inf
    mask = rng.random(A) < 0.6
    e_valid = rng.random(E) < 0.9
    t_valid = 450
    z_bounds = np.array([2.0, 5000.0], np.float32)

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    before = K.LAUNCHES["fused_quantize"]
    got = K.fused_quantize_lanes(
        torch.from_numpy(cube).to(dev).unsqueeze(0), torch.zeros(1, dtype=torch.int32, device=dev),
        _lane(mask, dev), _lane(e_valid, dev), i32(t_valid), i32(t_start), i32(t_count), _lane(z_bounds, dev),
        z_scale=z_scale,
    )
    assert K.LAUNCHES["fused_quantize"] == before + (dev.type == "cuda")

    spec = S.RenderSpec(8, 8, "linear", z_scale)
    m_np = _nansum_chain(cube, mask, t_valid)
    ref = S.quantize_matrix(
        _lane(m_np, dev), _lane(np.geomspace(4000, 1, E).astype(np.float32), dev), _lane(e_valid, dev),
        i32(t_valid), i32(t_start), i32(t_count), _lane(z_bounds, dev), spec, skip_percentile=True,
    )
    np.testing.assert_array_equal(_np(got["idx"])[0], _np(ref["idx"])[0])
    assert float(got["vmin"][0]) == pytest.approx(float(ref["vmin"][0]), rel=0, abs=0)
    in_file = np.arange(T)[:, None] < t_valid
    oracle_colnan = np.all(np.isnan(m_np) | ~in_file, axis=0)
    np.testing.assert_array_equal(_np(got["col_all_nan"])[0], oracle_colnan)


def _gate_inputs(rng, dev):
    T, A, E = 100, 4, 120
    cube = (rng.random((T, A, E)) * 100).astype(np.float32)
    mask = np.ones(A, bool)
    lanes = (torch.from_numpy(cube).to(dev).unsqueeze(0), torch.zeros(1, dtype=torch.int32, device=dev),
             _lane(mask, dev), torch.tensor([T], dtype=torch.int32, device=dev))
    return cube, mask, lanes


def test_collapse_cube_pallas_shape_gate(rng, dev):
    """test_pallas.py::test_collapse_cube_pallas_shape_gate, as the port's collapse kernel takes it.

    The Pallas kernel rejects the JAX test's (100, 4, 120) cube because T
    and E are not multiples of its tiles.  The CUDA kernel masks its own
    edges, so the port takes that shape: its result must equal numpy's
    nansum chain.  What the wrapper does reject is input the kernel cannot
    read -- a float64 cube, a mask of the wrong shape -- with the JAX
    test's ``ValueError``.
    """
    cube, mask, (cubes, u_idx, masks, t_valid) = _gate_inputs(rng, dev)
    got = K.collapse_lanes(cubes, u_idx, masks, t_valid)
    np.testing.assert_array_equal(_np(got)[0], _nansum_chain(cube, mask, cube.shape[0]))
    with pytest.raises(ValueError):
        K.collapse_lanes(cubes.double(), u_idx, masks, t_valid)
    with pytest.raises(ValueError):
        K.collapse_lanes(cubes, u_idx, masks[:, :-1], t_valid)


def test_fused_quantize_pallas_shape_gate(rng, dev):
    """test_pallas.py::test_fused_quantize_pallas_shape_gate, as the port's fused kernel takes it.

    As for the collapse: the port takes the JAX test's (100, 4, 120) cube
    (its index matrix must equal the unfused chain's: numpy's nansum, then
    the port's explicit-bounds analysis), and rejects with ``ValueError``
    input the kernel cannot read.
    """
    cube, mask, (cubes, u_idx, masks, t_valid) = _gate_inputs(rng, dev)
    E = cube.shape[2]
    e_valid = _lane(np.ones(E, bool), dev)
    zeros = torch.zeros(1, dtype=torch.int32, device=dev)
    zb = _lane(np.array([0.0, 1.0], np.float32), dev)
    got = K.fused_quantize_lanes(cubes, u_idx, masks, e_valid, t_valid, zeros, t_valid, zb)
    want = S.quantize_matrix(_lane(_nansum_chain(cube, mask, cube.shape[0]), dev),
                             _lane(np.geomspace(4000, 1, E).astype(np.float32), dev), e_valid, t_valid, zeros,
                             t_valid, zb, S.RenderSpec(8, 8, "linear", "log"), skip_percentile=True)
    np.testing.assert_array_equal(_np(got["idx"]), _np(want["idx"]))
    with pytest.raises(ValueError):
        K.fused_quantize_lanes(cubes.double(), u_idx, masks, e_valid, t_valid, zeros, t_valid, zb)
    with pytest.raises(ValueError):
        K.fused_quantize_lanes(cubes, u_idx, masks, e_valid[:, :-1], t_valid, zeros, t_valid, zb)


def test_render_kernel_pallas_production_switch(rng, monkeypatch, dev):
    """test_pallas.py::test_render_kernel_pallas_production_switch, as the port routes its buckets.

    The JAX package routes explicit-bounds log-z buckets through its fused
    kernel only under ``CST_RENDER_KERNEL=pallas``; the port has no switch:
    a bucket with finite explicit bounds always takes the fused kernel, and
    a percentile bucket the collapse kernel, then the eager analysis.  The
    JAX test's assertion holds on that routing: the production render's
    pixels and bounds equal the unfused path's (each panel's collapse, then
    ``render_matrix``), with the fused wrapper called for the explicit
    bucket and the collapse wrapper for the percentile one.
    """
    calls = {"fused": 0, "collapse": 0}
    for name, key in (("fused_quantize_lanes", "fused"), ("collapse_lanes", "collapse")):
        real = getattr(dispatch, name)

        def counting(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(dispatch, name, counting)
    panels = []
    for k in range(3):
        T, A, E = 48 + k, 6, 12
        cube = (rng.random((T, A, E)) * 1e3).astype(np.float32)
        cube[rng.random((T, A, E)) < 0.05] = np.nan
        panels.append(PanelData(
            cube=cube, pitch_mask=np.ones(A, bool), energy=np.geomspace(4000, 10, E).astype(np.float32),
            times=np.arange(T, dtype=np.float64), window=TimeWindow(0, T, (0.0, float(T - 1)), (0.0, float(T - 1))),
            y_min=0.0, y_max=4000.0, z_min=1.0, z_max=900.0, y_scale="log", z_scale="log", colormap="inferno",
            x_is_unix=False, z_label="Counts",
        ))
    panels.append(PanelData(**{**panels[0].__dict__, "z_min": None, "z_max": None}))  # a percentile bucket
    routed = dispatch.device_render_panels(panels, 16, 24)
    assert calls == {"fused": 1, "collapse": 1}
    spec = S.RenderSpec(16, 24, "log", "log")
    for p, r in zip(panels, routed):
        T = p.cube.shape[0]
        m = S.collapse_cube(torch.from_numpy(p.cube).to(dev), torch.from_numpy(p.pitch_mask).to(dev), T)
        zb = np.array([np.nan if p.z_min is None else p.z_min, np.nan if p.z_max is None else p.z_max], np.float32)
        base = S.render_matrix(
            m.unsqueeze(0), _lane(p.energy, dev), _lane((p.energy >= p.y_min) & (p.energy <= p.y_max), dev),
            torch.tensor([T], device=dev), torch.tensor([0], device=dev), torch.tensor([T], device=dev),
            _lane(make_x_map(p.window, 24), dev), _lane(zb, dev), _lane(colormap_lut(p.colormap), dev), spec,
        )
        np.testing.assert_array_equal(r["rgba"], _np(base["rgba"])[0])
        assert r["vmin"] == pytest.approx(float(base["vmin"][0]))
        assert r["vmax"] == pytest.approx(float(base["vmax"][0]))


# ---------------------------------------------------------------------------
# tests/test_parallel.py, tests/test_production_sharding.py, tests/test_multihost.py,
# tests/test_graft_entry.py: the parallel layer in one two-rank Gloo group on the CPU
# ---------------------------------------------------------------------------

N_RANKS = 2


def _build_panels(rng, n_panels):
    """tests/test_production_sharding.py's panels."""
    panels = []
    for k in range(n_panels):
        T, A, E = 60 + 3 * k, 6, 12
        cube = (rng.random((T, A, E)) * (50 + 10 * k)).astype(np.float32)
        cube[rng.random(cube.shape) < 0.05] = np.nan
        panels.append(PanelData(
            cube=cube, pitch_mask=np.ones(A, bool), energy=np.geomspace(4000, 10, E).astype(np.float32),
            times=np.arange(T, dtype=np.float64), window=TimeWindow(0, T, (0.0, float(T - 1)), (0.0, float(T - 1))),
            y_min=0.0, y_max=4000.0, z_min=None, z_max=None, y_scale="log", z_scale="log", colormap="inferno",
            x_is_unix=False, z_label="Counts",
        ))
    return panels


def _mixed_panels(rng):
    """test_mixed_bucket_group_shards_and_matches's panels: two T buckets, percentile and explicit bounds."""
    short = _build_panels(rng, 3)
    long = _build_panels(rng, 3)
    for k, p in enumerate(long):
        T, A, E = 300 + 5 * k, 6, 12
        p.cube = (rng.random((T, A, E)) * 80).astype(np.float32)
        p.times = np.arange(T, dtype=np.float64)
        p.window = TimeWindow(0, T, (0.0, float(T - 1)), (0.0, float(T - 1)))
    explicit = _build_panels(rng, 2)
    for p in explicit:
        p.z_min, p.z_max = 0.5, 5e3
    return short + long + explicit


def _render_results(panels, tile_h=32, tile_w=48):
    return dispatch.device_render_panels(panels, tile_h, tile_w)


def _panel_arrays(panels, H, W) -> dict:
    """The panels as the arrays of ``parallel.sharded_batch_render`` (cubes NaN-padded to the longest)."""
    Tm = max(p.cube.shape[0] for p in panels)
    _, A, E = panels[0].cube.shape
    cubes = np.full((len(panels), Tm, A, E), np.nan, np.float32)
    for i, p in enumerate(panels):
        cubes[i, : p.cube.shape[0]] = p.cube
    return dict(
        cubes=cubes,
        pitch_masks=np.stack([p.pitch_mask for p in panels]),
        t_valids=np.array([p.cube.shape[0] for p in panels], np.int32),
        energies=np.stack([p.energy for p in panels]),
        e_valids=np.stack([(p.energy >= p.y_min) & (p.energy <= p.y_max) for p in panels]),
        t_starts=np.array([p.window.t_start for p in panels], np.int32),
        t_counts=np.array([p.window.t_count for p in panels], np.int32),
        x_maps=np.stack([make_x_map(p.window, W) for p in panels]),
        z_bounds=np.array([[np.nan if p.z_min is None else p.z_min, np.nan if p.z_max is None else p.z_max]
                           for p in panels], np.float32),
        luts=np.stack([colormap_lut(p.colormap) for p in panels]),
    )


def _unsharded_render(spec, arrays: dict, i: int) -> dict:
    """Panel *i* through the one-device path: its collapse, then ``render_matrix`` alone (on the CPU)."""
    def one(key, dtype=None):
        return _lane(arrays[key][i], "cpu", dtype)

    tv = int(arrays["t_valids"][i])
    m = S.collapse_cube(torch.from_numpy(arrays["cubes"][i]), torch.from_numpy(arrays["pitch_masks"][i]), tv)
    out = S.render_matrix(
        m.unsqueeze(0), one("energies"), one("e_valids"), one("t_valids"), one("t_starts"), one("t_counts"),
        one("x_maps"), one("z_bounds"), one("luts"), spec,
    )
    return {k: _np(v)[0] for k, v in out.items()}


def _parallel_extrema_inputs(rng):
    """tests/test_parallel.py::test_sharded_extrema_matches_single_device's files."""
    N, T, A, E = 8, 32, 4, 8
    cubes = (rng.random((N, T, A, E)) * 50).astype(np.float32)
    cubes[rng.random(cubes.shape) < 0.1] = np.nan
    t_valids = rng.integers(8, T, size=N).astype(np.int32)
    for i in range(N):
        cubes[i, t_valids[i]:] = np.nan
    return cubes, t_valids


def _parallel_render_inputs(rng) -> dict:
    """tests/test_parallel.py::test_sharded_render_matches_single_device's batch."""
    N, T, A, E = 8, 40, 4, 8
    W = 64
    cubes = (rng.random((N, T, A, E)) * 100).astype(np.float32)
    return dict(
        cubes=cubes, pitch_masks=np.ones((N, A), bool), t_valids=np.full(N, T, np.int32),
        energies=np.tile(np.geomspace(4000, 10, E).astype(np.float32), (N, 1)), e_valids=np.ones((N, E), bool),
        t_starts=np.zeros(N, np.int32), t_counts=np.full(N, T, np.int32),
        x_maps=np.tile(np.array([T / W, 0.5 * T / W], np.float32), (N, 1)),
        z_bounds=np.full((N, 2), np.nan, np.float32), luts=np.tile(colormap_lut("viridis")[None], (N, 1, 1)),
    )


def _bad_batch() -> dict:
    """tests/test_parallel.py::test_sharded_render_rejects_bad_batch's three panels."""
    return dict(
        cubes=np.zeros((3, 4, 2, 2), np.float32), pitch_masks=np.ones((3, 2), bool), t_valids=np.full(3, 4, np.int32),
        energies=np.ones((3, 2), np.float32), e_valids=np.ones((3, 2), bool), t_starts=np.zeros(3, np.int32),
        t_counts=np.full(3, 4, np.int32), x_maps=np.zeros((3, 2), np.float32), z_bounds=np.zeros((3, 2), np.float32),
        luts=np.zeros((3, 256, 4), np.uint8),
    )


def _file_stats_cubes(rng) -> list[np.ndarray]:
    """tests/test_production_sharding.py::test_batched_file_stats_sharded_matches_unsharded's five files."""
    cubes = []
    for k in range(5):
        c = (rng.random((30 + k, 4, 8)) * 100).astype(np.float32)
        c[rng.random(c.shape) < 0.1] = np.nan
        cubes.append(c)
    return cubes


def _multihost_inputs():
    """tests/multihost_worker.py's archive (16 files of two hosts) and render panels."""
    rng = np.random.default_rng(99)
    n_files, T, A, E = 8 * N_RANKS, 32, 8, 16
    cubes = (rng.random((n_files, T, A, E)) * 1e4).astype(np.float32)
    cubes[rng.random(cubes.shape) < 0.1] = np.nan
    t_valids = np.asarray([T - (i % 3) for i in range(n_files)], np.int32)
    for i, tv in enumerate(t_valids):
        cubes[i, tv:] = np.nan
    prng = np.random.default_rng(7)
    panels = []
    for k in range(6):
        Tp, Ap, Ep = 40 + k, 6, 12
        cube = (prng.random((Tp, Ap, Ep)) * 100).astype(np.float32)
        panels.append(PanelData(
            cube=cube, pitch_mask=np.ones(Ap, bool), energy=np.geomspace(4000, 10, Ep).astype(np.float32),
            times=np.arange(Tp, dtype=np.float64),
            window=TimeWindow(0, Tp, (0.0, float(Tp - 1)), (0.0, float(Tp - 1))),
            y_min=0.0, y_max=4000.0, z_min=None, z_max=None, y_scale="log", z_scale="log", colormap="inferno",
            x_is_unix=False, z_label="Counts",
        ))
    return cubes, t_valids, panels


_PRODUCTION_SPEC = ("log", "log")
_INSTRUMENTS = ("ees", "eeb", "ies", "ieb")


def _extrema_scan(root: str, json_path: str) -> tuple[dict, dict]:
    from configurable_spectrograms_torch.fast.extrema import compute_global_extrema

    out = compute_global_extrema(root, "linear", "log", _INSTRUMENTS, extrema_json_path=json_path, max_percentile=95.0)
    return out, json.loads(Path(json_path).read_text())


def _assertion_rank(rank, inputs):
    """One rank of the group: every collective and in-group render the tests below hold, and their errors."""
    from configurable_spectrograms_torch.ops.extrema_ops import batched_file_stats
    from configurable_spectrograms_torch.parallel import make_mesh, sharded_batch_render, sharded_extrema_stats
    from configurable_spectrograms_torch.parallel.mesh import data_parallel_mesh, global_file_batch
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    out = {"rank": rank, "device": str(get_device())}
    data = make_mesh(N_RANKS)
    data_time = make_mesh(N_RANKS, axis_names=("data", "time"), axis_sizes=(1, N_RANKS))
    out["mesh_shapes"] = [dict(zip(m.mesh_dim_names, m.shape)) for m in (data, data_time)]
    errors = {}
    for name, bad in (("huge_mesh", lambda: make_mesh(10**6)),
                      ("bad_batch", lambda: sharded_batch_render(data, S.RenderSpec(8, 8), **_bad_batch()))):
        try:
            bad()
            errors[name] = None
        except ValueError as exc:
            errors[name] = str(exc)
    out["errors"] = errors

    out["parallel_extrema"] = sharded_extrema_stats(*inputs["parallel_extrema"], data_time)
    out["parallel_render"] = sharded_batch_render(data, S.RenderSpec(32, 64, "linear", "log"),
                                                  **inputs["parallel_render"])

    for name in ("production", "explicit", "mixed"):
        panels = inputs[name]
        t0 = device_cache.upload_telemetry()
        out[f"{name}_device"] = _render_results(panels)
        out[f"{name}_dispatches"] = device_cache.upload_telemetry()["dispatches"] - t0["dispatches"]
        out[f"{name}_last_dispatch"] = dispatch.LAST_DISPATCH["device"]
        out[f"{name}_sharded"] = sharded_batch_render(data, S.RenderSpec(32, 48, *_PRODUCTION_SPEC),
                                                      **_panel_arrays(panels, 32, 48))

    files = inputs["file_stats"]
    out["file_stats_in_group"] = batched_file_stats(files)
    Tm = max(c.shape[0] for c in files) + 1
    padded = np.full((len(files) + 1, Tm, *files[0].shape[1:]), np.nan, np.float32)  # six files: two per rank
    for i, c in enumerate(files):
        padded[i, : c.shape[0]] = c
    t_valids = np.array([c.shape[0] for c in files] + [0], np.int32)
    out["file_stats_sharded"] = sharded_extrema_stats(padded, t_valids, data)

    root, tmp = inputs["archive"]
    out["extrema_scan"] = _extrema_scan(root, os.path.join(tmp, f"extrema_rank{rank}.json"))

    cubes, t_valids, mh_panels = inputs["multihost"]
    per = cubes.shape[0] // N_RANKS
    local = slice(rank * per, (rank + 1) * per)
    shard = global_file_batch(cubes[local], t_valids[local], data)
    out["multihost_extrema"] = sharded_extrema_stats(shard, None, data)
    ref = batched_file_stats([cubes[i, : t_valids[i]] for i in range(cubes.shape[0])])
    out["multihost_single"] = (np.stack([r["counts"] for r in ref]), np.sum([r["hist"] for r in ref], axis=0))
    mesh = data_parallel_mesh()
    out["multihost_mesh"] = None if mesh is None else (mesh.mesh_dim_names, mesh.size())
    out["multihost_device"] = dispatch.device_render_panels(mh_panels, 24, 32)
    out["multihost_last_dispatch"] = dispatch.LAST_DISPATCH["device"]
    os.environ["CST_RENDER_BACKEND"] = "host"
    out["multihost_host"] = dispatch.device_render_panels(mh_panels, 24, 32)
    del os.environ["CST_RENDER_BACKEND"]
    return out


@pytest.fixture(scope="module")
def port_archive(tmp_path_factory):
    """tests/conftest.py's ``synth_archive`` (3 orbits x 4 instruments), from the port's data.synthetic."""
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("fast_data")
    csv = root / "cusp.tsv"
    synth_fast_archive(str(root), [100, 101, 102], n_time=96, n_angle=16, n_energy=24, cusp_csv_path=str(csv))
    return str(root)


@pytest.fixture(scope="module")
def group_inputs(port_archive, tmp_path_factory) -> dict:
    """Every input of the group's run, each drawn as its JAX test draws it (a fresh ``rng`` per JAX test)."""
    return {
        "parallel_extrema": _parallel_extrema_inputs(np.random.default_rng(1234)),
        "parallel_render": _parallel_render_inputs(np.random.default_rng(1234)),
        "production": _build_panels(np.random.default_rng(1234), 10),
        "explicit": [_explicit(p) for p in _build_panels(np.random.default_rng(1234), 10)],
        "mixed": _mixed_panels(np.random.default_rng(1234)),
        "file_stats": _file_stats_cubes(np.random.default_rng(1234)),
        "archive": (port_archive, str(tmp_path_factory.mktemp("extrema_ranks"))),
        "multihost": _multihost_inputs(),
    }


def _explicit(p):
    p.z_min, p.z_max = 0.5, 5e3  # explicit bounds: the sort-free program
    return p


@pytest.fixture(scope="module")
def group_results(group_inputs) -> list[dict]:
    """:func:`_assertion_rank` in two spawned ranks on the CPU, one Gloo group."""
    from configurable_spectrograms_torch.entry import spawn_ranks

    env = {"CST_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1", "CST_RENDER_BACKEND": "device"}
    return spawn_ranks(_assertion_rank, N_RANKS, "gloo", args=(group_inputs,), env=env, timeout=600)


@pytest.fixture
def on_the_ranks_device(monkeypatch):
    """References computed here run where the ranks run: the CPU."""
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")


def test_make_mesh_shapes(group_results):
    """test_parallel.py::test_make_mesh_shapes, on a group of two ranks (the JAX test's 8 virtual devices
    become the group's ranks: ('data',) of 2 and ('data', 'time') of 1 x 2)."""
    for r in group_results:
        assert r["mesh_shapes"] == [{"data": 2}, {"data": 1, "time": 2}]
        assert r["errors"]["huge_mesh"] == "requested 1000000 devices but only 2 available"


def test_sharded_extrema_matches_single_device(group_results, group_inputs, on_the_ranks_device):
    """test_parallel.py::test_sharded_extrema_matches_single_device (a ('data', 'time') mesh of 1 x 2)."""
    from configurable_spectrograms_torch.ops.extrema_ops import batched_file_stats, hist_percentile

    cubes, t_valids = group_inputs["parallel_extrema"]
    N = cubes.shape[0]
    ref = batched_file_stats([cubes[i, : t_valids[i]] for i in range(N)])
    ref_counts = np.stack([r["counts"] for r in ref])
    ref_hist = np.sum([r["hist"] for r in ref], axis=0)
    for r in group_results:
        counts, hist = r["parallel_extrema"]
        np.testing.assert_array_equal(counts, ref_counts)
        np.testing.assert_array_equal(hist, ref_hist)
        pooled = []
        for i in range(N):
            c = np.nansum(np.nan_to_num(cubes[i, : t_valids[i]], nan=0.0), axis=1)
            pooled.append(c[np.isfinite(c) & (c > 0)])
        exact = np.nanpercentile(np.concatenate(pooled), 95.0)
        assert hist_percentile(hist, 95.0) == pytest.approx(exact, rel=0.02)


def test_sharded_render_matches_single_device(group_results, group_inputs):
    """test_parallel.py::test_sharded_render_matches_single_device: panel 3 against the unsharded one-panel path."""
    args = group_inputs["parallel_render"]
    spec = S.RenderSpec(height=32, width=64, y_scale="linear", z_scale="log")
    single = _unsharded_render(spec, args, 3)
    for r in group_results:
        out = r["parallel_render"]
        assert out["rgba"].shape == (8, 32, 64, 4)
        np.testing.assert_array_equal(out["rgba"][3], single["rgba"])
        np.testing.assert_allclose(out["vmin"][3], float(single["vmin"]), rtol=1e-6)


def test_sharded_render_rejects_bad_batch(group_results):
    """test_parallel.py::test_sharded_render_rejects_bad_batch"""
    for r in group_results:
        assert r["errors"]["bad_batch"] == "panel batch (3) must be a multiple of the data axis (2)"


def test_data_parallel_mesh_never_enumerates_devices_on_host_backend(monkeypatch):
    """test_parallel.py::test_data_parallel_mesh_never_enumerates_devices_on_host_backend: on the host
    backend, outside a group, ``data_parallel_mesh()`` is None without asking torch for its devices."""
    from configurable_spectrograms_torch.parallel import mesh as mesh_mod

    monkeypatch.setenv("CST_RENDER_BACKEND", "host")

    def _boom(*a, **k):  # the hang, made loud
        raise AssertionError("device enumeration must not happen on the host backend")

    monkeypatch.setattr(torch.cuda, "device_count", _boom)
    monkeypatch.setattr(torch.cuda, "is_available", _boom)
    assert mesh_mod.data_parallel_mesh() is None


def _assert_same_results(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for s, u in zip(got, want):
        np.testing.assert_array_equal(s["rgba"], u["rgba"])
        for key in ("vmin", "vmax"):
            assert s[key] == pytest.approx(u[key]), key


def _assert_sharded_matches(name: str, group_results, group_inputs) -> None:
    """The group's in-group production render equals this process's, and its mesh-sharded render the unsharded one."""
    panels = group_inputs[name]
    single = _render_results(panels)
    arrays = _panel_arrays(panels, 32, 48)
    spec = S.RenderSpec(32, 48, *_PRODUCTION_SPEC)
    unsharded = [_unsharded_render(spec, arrays, i) for i in range(len(panels))]
    for r in group_results:
        assert r[f"{name}_last_dispatch"] == r["device"] == "cpu"
        _assert_same_results(r[f"{name}_device"], single)
        sharded = r[f"{name}_sharded"]
        for i, u in enumerate(unsharded):
            np.testing.assert_array_equal(sharded["rgba"][i], u["rgba"])
            for key in ("vmin", "vmax", "y0", "y1", "n_kept", "empty"):
                assert sharded[key][i] == pytest.approx(u[key]), key


def test_production_render_spans_mesh_and_matches_unsharded(group_results, group_inputs, on_the_ranks_device):
    """test_production_sharding.py::test_production_render_spans_mesh_and_matches_unsharded.

    The port's production render has no mesh: under a group each rank
    renders its own orbits' panels on its own device (one process per
    card).  So the JAX test's two arms become: the production render run
    inside a two-rank group equals this process's, on the rank's device;
    and the mesh-sharded render of the same ten panels
    (``parallel.sharded_batch_render``, five lanes a rank) equals each
    panel's unsharded render.
    """
    _assert_sharded_matches("production", group_results, group_inputs)


def test_explicit_bounds_program_shards_and_matches(group_results, group_inputs, on_the_ranks_device):
    """test_production_sharding.py::test_explicit_bounds_program_shards_and_matches (as the test above,
    with explicit bounds: the fused route of the production render)."""
    _assert_sharded_matches("explicit", group_results, group_inputs)


def test_mixed_bucket_group_shards_and_matches(group_results, group_inputs, on_the_ranks_device):
    """test_production_sharding.py::test_mixed_bucket_group_shards_and_matches: two T buckets and both
    programs in one call make three dispatches, in the group and alone, and match."""
    t0 = device_cache.upload_telemetry()
    _assert_sharded_matches("mixed", group_results, group_inputs)
    assert device_cache.upload_telemetry()["dispatches"] - t0["dispatches"] == 3
    for r in group_results:
        assert r["mixed_dispatches"] == 3


def test_batched_file_stats_sharded_matches_unsharded(group_results, group_inputs, on_the_ranks_device):
    """test_production_sharding.py::test_batched_file_stats_sharded_matches_unsharded.

    The five files through ``batched_file_stats`` inside the group equal
    this process's, file by file; and through the mesh-sharded reduction
    (padded to six files, three a rank) the per-file counts and the
    global histogram equal the unsharded stats (the sharded reduction
    returns only the global histogram, which is the per-file ones' sum).
    """
    from configurable_spectrograms_torch.ops.extrema_ops import batched_file_stats

    single = batched_file_stats(group_inputs["file_stats"])
    assert len(single) == 5
    for r in group_results:
        assert len(r["file_stats_in_group"]) == 5
        for s, u in zip(r["file_stats_in_group"], single):
            np.testing.assert_array_equal(s["counts"], u["counts"])
            np.testing.assert_array_equal(s["hist"], u["hist"])
        counts, hist = r["file_stats_sharded"]
        np.testing.assert_array_equal(counts[:5], np.stack([u["counts"] for u in single]))
        assert not counts[5].any()
        np.testing.assert_array_equal(hist, np.sum([u["hist"] for u in single], axis=0))


def test_extrema_scan_identical_with_and_without_mesh(group_results, group_inputs, tmp_path, on_the_ranks_device):
    """test_production_sharding.py::test_extrema_scan_identical_with_and_without_mesh: the folder scan
    run in each rank of a group writes the same JSON, and returns the same extrema, as one process."""
    root, _ = group_inputs["archive"]
    single = _extrema_scan(root, str(tmp_path / "extrema_single.json"))
    for r in group_results:
        out, state = r["extrema_scan"]
        assert out == single[0]
        assert state == single[1]


def test_host_file_stats_matches_device(rng):
    """test_production_sharding.py::test_host_file_stats_matches_device: the numpy stats bit for bit
    against the device reduction (the collapse kernel on a card)."""
    from configurable_spectrograms_torch.ops.extrema_ops import batched_file_stats, host_file_stats

    cube = (rng.random((50, 6, 10)) * 1e4).astype(np.float32)
    cube[rng.random(cube.shape) < 0.15] = np.nan
    cube[3, 2, 4] = np.inf
    device = batched_file_stats([cube])[0]
    host = host_file_stats(cube)
    np.testing.assert_array_equal(device["counts"], host["counts"])
    np.testing.assert_array_equal(device["hist"], host["hist"])


def test_repeat_render_reuses_resident_cubes(rng):
    """test_production_sharding.py::test_repeat_render_reuses_resident_cubes: one upload per cube, none on repeat."""
    panels = _build_panels(rng, 4)
    t0 = device_cache.upload_telemetry()
    first = _render_results(panels)
    first_uploads = device_cache.upload_telemetry()["cube_misses"] - t0["cube_misses"]
    assert first_uploads == 4  # one per unique cube
    second = _render_results(panels)
    assert device_cache.upload_telemetry()["cube_misses"] - t0["cube_misses"] == first_uploads
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a["rgba"], b["rgba"])


def test_two_process_extrema_reduction(group_results):
    """test_multihost.py::test_two_process_extrema_reduction (tests/multihost_worker.py's checks, each rank a host).

    Each rank holds half of the 16 files; ``global_file_batch`` and the
    sharded reduction must give both ranks the one-process stats of the
    whole archive, and the same histogram total.  Then the worker's render
    check: the group's data-parallel mesh spans it, and the device
    render equals the host backend's, bit for bit.
    """
    totals = set()
    for r in group_results:
        counts, hist = r["multihost_extrema"]
        np.testing.assert_array_equal(counts, r["multihost_single"][0])
        np.testing.assert_array_equal(hist, r["multihost_single"][1])
        totals.add(int(hist.sum()))
        assert r["multihost_mesh"] == (("data",), N_RANKS)
        assert r["multihost_last_dispatch"] == r["device"]
        for d, h in zip(r["multihost_device"], r["multihost_host"], strict=True):
            np.testing.assert_array_equal(d["rgba"], h["rgba"])
    assert len(totals) == 1, totals


def _flagship_rank(rank, archive, csv, out_base, progress):
    """tests/multihost_flagship_worker.py: the flagship driver over the shared archive, one output tree."""
    from configurable_spectrograms_torch.data import cdf_utils
    from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_directory
    from configurable_spectrograms_torch.parallel.mesh import process_shard_info

    n = int(os.environ["CST_FLAGSHIP_RANKS"])
    assert process_shard_info() == (rank, n)
    cdf_utils.filtered_orbits_cache.clear()
    os.environ["CST_CUSP_CSV"] = csv
    results = FAST_plot_spectrograms_directory(
        directory_path=archive, y_scale="log", z_scale="log", colormap="inferno", output_base=out_base,
        progress_json_path=progress, max_processing_percentile=99.0,
        extrema_json_path=os.path.join(os.path.dirname(progress), "extrema.json"), max_workers=1, verbose=False,
        use_tqdm=False,
    )
    return sum(1 for r in results if r.get("status") == "ok"), len(results)


def test_two_process_flagship_batch_matches_single_host(tmp_path, on_the_ranks_device):
    """test_multihost.py::test_two_process_flagship_batch_matches_single_host: two Gloo ranks split the
    orbits into one output tree, byte-identical to one rank's run of the same archive."""
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive
    from configurable_spectrograms_torch.entry import spawn_ranks

    archive = tmp_path / "data"
    csv = tmp_path / "cusp.tsv"
    synth_fast_archive(str(archive), [3001, 3002], n_time=256, n_angle=16, n_energy=24, cusp_csv_path=str(csv))
    env = {"CST_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1", "CST_FAST_SAVE_DPI": "50"}
    trees = {}
    for n in (2, 1):
        out = tmp_path / f"out_{n}"
        state = tmp_path / f"state_{n}"
        state.mkdir()
        runs = spawn_ranks(_flagship_rank, n, "gloo", env={**env, "CST_FLAGSHIP_RANKS": str(n)}, timeout=420,
                           args=(str(archive), str(csv), str(out), str(state / "progress.json")))
        assert all(ok == total > 0 for ok, total in runs), runs
        trees[n] = {p.relative_to(out): p for p in out.rglob("*.png")}
    assert trees[2], "the two-rank run produced no figures"
    assert set(trees[2]) == set(trees[1]), (sorted(set(trees[1]) - set(trees[2])), sorted(set(trees[2]) - set(trees[1])))
    for rel, path in sorted(trees[2].items()):
        assert path.read_bytes() == trees[1][rel].read_bytes(), f"{rel} differs"


def test_entry_forward_jits(dev):
    """test_graft_entry.py::test_entry_forward_jits: the port's ``entry()`` forward on its device."""
    from configurable_spectrograms_torch.entry import entry

    fn, args = entry(dev)
    rgba, vmin, vmax = fn(*args)
    assert tuple(rgba.shape) == (128, 256, 4) and rgba.dtype == torch.uint8
    assert float(vmax) > float(vmin)


# ---------------------------------------------------------------------------
# tests/test_render_service.py: the readback and the coalescer
# ---------------------------------------------------------------------------


def _service_panel(rng, T=40, A=6, E=10, cmap="viridis"):
    """tests/test_render_service.py's panel."""
    cube = (rng.random((T, A, E)) * 100).astype(np.float32)
    return PanelData(
        cube=cube, pitch_mask=np.ones(A, bool), energy=np.geomspace(4000, 10, E).astype(np.float32),
        times=np.arange(T, dtype=np.float64), window=TimeWindow(0, T, (0.0, float(T - 1)), (0.0, float(T - 1))),
        y_min=0.0, y_max=4000.0, z_min=None, z_max=None, y_scale="linear", z_scale="log", colormap=cmap,
        x_is_unix=True, z_label="Counts",
    )


def test_multi_bucket_readbacks_overlap(rng, monkeypatch):
    """test_render_service.py::test_multi_bucket_readbacks_overlap, as the port's readback works.

    The JAX package reads each bucket back on a thread, and the test
    holds two 0.6 s readbacks to under 1.1 s.  The port has no readback
    thread to slow: each bucket's one packed device-to-host copy is queued
    on the device stream behind its kernels when the bucket is enqueued,
    and :meth:`PendingRender.wait` only waits for it.  So bucket N+1's
    readback cannot wait for bucket N's: both buckets are enqueued, with
    their copies queued (an event each on a card), before the first wait,
    and a wait that takes 0.6 s per bucket delays nothing but the waiting
    thread.  Both buckets take the device path and equal the direct render.
    """
    panels = [_service_panel(rng, T=40), _service_panel(rng, T=300)]
    direct = dispatch.device_render_panels(panels, 16, 24)
    waits = []
    real_unpack = drain.PendingRender._unpack

    def slow_unpack(self, b):
        waits.append(len(self.buckets))
        time.sleep(0.6)
        return real_unpack(self, b)

    monkeypatch.setattr(drain.PendingRender, "_unpack", slow_unpack)
    pending = dispatch.enqueue_render_panels(panels, 16, 24)
    assert len(pending.buckets) == 2 and pending.has_device_work()  # both copies queued before any wait
    on_card = torch.device(os.environ["CST_TORCH_DEVICE"]).type == "cuda"
    assert all((b.event is not None) == on_card for b in pending.buckets)  # a card's copies: queued, with events
    results = pending.wait()
    assert waits == [2, 1]  # one wait per bucket, in order, after both were enqueued
    assert all(r is not None and "rgba" in r for r in results)
    _assert_same_results(results, direct)


def test_bucket_readback_error_propagates(rng, monkeypatch):
    """test_render_service.py::test_bucket_readback_error_propagates: an exception in a bucket's
    readback fails the render call rather than dropping panels."""
    def broken_unpack(self, b):
        raise RuntimeError("transfer exploded")

    monkeypatch.setattr(drain.PendingRender, "_unpack", broken_unpack)
    with pytest.raises(RuntimeError, match="transfer exploded"):
        dispatch.device_render_panels([_service_panel(rng)], 16, 24)


def test_coalescer_overlaps_batches(rng, monkeypatch):
    """test_render_service.py::test_coalescer_overlaps_batches: while batch A drains on a side thread the
    dispatcher enqueues batch B, so two batches with a 0.7 s readback each finish in under 1.35 s."""
    fresh = service.RenderCoalescer()
    fresh.render([_service_panel(rng)], 16, 24)  # warm up
    real_wait = drain.PendingRender.wait

    def slow_wait(self):
        time.sleep(0.7)
        return real_wait(self)

    monkeypatch.setattr(drain.PendingRender, "wait", slow_wait)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        fa = pool.submit(fresh.render, [_service_panel(rng)], 16, 24)
        time.sleep(0.1)  # A must be in flight before B arrives (no co-batching)
        fb = pool.submit(fresh.render, [_service_panel(rng)], 16, 24)
        ra, rb = fa.result(), fb.result()
    elapsed = time.perf_counter() - t0
    assert all("rgba" in r for r in ra + rb)
    assert elapsed < 1.35, f"two 0.7s batches took {elapsed:.2f}s -- dispatcher serialized?"


# ---------------------------------------------------------------------------
# tests/test_compositor.py, tests/test_fuzz_parity.py, tests/test_host_backend.py
# ---------------------------------------------------------------------------


def test_recommended_workers_host_vs_device(monkeypatch):
    """test_compositor.py::test_recommended_workers_host_vs_device.

    The host backend clamps the feeder threads to the visible cores, the
    device backend keeps the count asked for.  The JAX test's third arm,
    ``auto`` tripped to the host by the relay's detector, is the relay's
    (ROADMAP rule 5): the port's backends are ``device`` and ``host``, and
    ``auto`` is refused.
    """
    from configurable_spectrograms_torch.render import backend

    cores = len(os.sched_getaffinity(0))
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    assert backend.recommended_workers(4) == min(4, cores)
    assert backend.recommended_workers(0) == 1
    assert backend.recommended_workers(7) == min(7, cores)
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    assert backend.recommended_workers(4) == 4
    monkeypatch.setenv("CST_RENDER_BACKEND", "auto")
    with pytest.raises(ValueError, match="CST_RENDER_BACKEND"):
        backend.recommended_workers(4)


COLORMAPS = ("viridis", "plasma", "inferno", "magma", "turbo")


def _random_config(seed: int) -> dict:
    """tests/test_fuzz_parity.py's configuration of each seed."""
    rng = np.random.default_rng(seed)
    T = int(rng.integers(4, 260))
    E = int(rng.integers(3, 49))
    kind = rng.integers(0, 3)
    top = float(rng.uniform(50.0, 40000.0))
    bot = float(rng.uniform(0.5, 30.0))
    if kind == 0:
        energy = np.geomspace(top, bot, E)
    elif kind == 1:
        energy = np.geomspace(bot, top, E)
    else:
        energy = np.linspace(bot, top, E)
    energy = energy.astype(np.float32)
    y_min = 0.0
    y_max = float(rng.choice([4000.0, top * 2.0, float(rng.uniform(bot, top))]))
    e_valid = (energy >= y_min) & (energy <= y_max)
    scale = 10.0 ** float(rng.uniform(-2, 5))
    matrix = (rng.random((T, E)) * scale).astype(np.float32)
    for frac, val in ((0.08, np.nan), (0.02, np.inf), (0.02, -np.inf), (0.06, 0.0)):
        if rng.random() < 0.7:
            matrix[rng.random(matrix.shape) < frac] = val
    if rng.random() < 0.3:
        matrix[rng.random(matrix.shape) < 0.1] *= -1.0
    edge = rng.integers(0, 8)
    if edge == 0:
        matrix[:] = np.nan  # empty panel
    elif edge == 1:
        matrix[:] = np.float32(rng.uniform(0.1, 100.0))  # constant (vmin == vmax)
    elif edge == 2:
        matrix[:, rng.integers(0, E)] = np.nan  # one all-NaN column
    elif edge == 3:
        matrix = -np.abs(matrix)  # log-z: everything non-positive
    if rng.random() < 0.15:
        t_start, t_count = 0, T
    elif rng.random() < 0.1:
        t_start, t_count = int(rng.integers(0, T)), 0  # empty window
    else:
        t_start = int(rng.integers(0, max(T - 2, 1)))
        t_count = int(rng.integers(1, T - t_start + 1))
    if rng.random() < 0.5:
        lo = float(rng.uniform(0.0, 50.0))
        hi = float(rng.uniform(lo, 100.0)) if rng.random() < 0.9 else lo
        z_bounds = (None, None)
    else:
        lo, hi = 1.0, 99.0
        vmin = float(rng.uniform(0.0, scale * 0.5))
        vmax = vmin if rng.random() < 0.1 else float(rng.uniform(vmin, scale * 1.5))
        z_bounds = (vmin, vmax)
    return {
        "matrix": matrix, "energy": energy, "e_valid": e_valid, "t_start": t_start, "t_count": t_count,
        "z_bounds": z_bounds, "y_scale": str(rng.choice(["linear", "log"])),
        "z_scale": str(rng.choice(["linear", "log"])), "low_pct": lo, "high_pct": hi,
        "H": int(rng.integers(8, 96)), "W": int(rng.integers(8, 160)), "colormap": str(rng.choice(COLORMAPS)),
    }


def _assert_idx_parity(dev_idx, host_idx, sel, cfg, host, seed) -> bool:
    """tests/test_fuzz_parity.py's index contract; True when bit-exact.

    Bit-identical except cells proven to sit on a colormap-bin boundary,
    which may differ by exactly one bin (float32 ``log10`` ulps on log-z;
    the host's float64 span of explicit bounds on either scale).
    """
    diff_mask = (dev_idx != host_idx) & sel
    if not diff_mask.any():
        return True
    delta = np.abs(dev_idx.astype(np.int32) - host_idx.astype(np.int32))
    assert int(delta[diff_mask].max()) <= 1, f"seed {seed}: idx differs by >1 bin"
    vmin = float(host["vmin"])
    vmax = float(host["vmax"])
    assert vmax > vmin, f"seed {seed}: idx diverged with degenerate bounds"
    m = cfg["matrix"].astype(np.float64)
    if cfg["z_scale"] == "log":
        assert vmin > 0.0, f"seed {seed}: log-z idx diverged with non-positive vmin"
        lmin, lmax = np.log10(vmin), np.log10(vmax)
        span = lmax - lmin
        w = np.where(~np.isfinite(m) | (m <= 0.0), vmin, m)
        lw = np.log10(np.maximum(w, 1e-37))
        bins64 = (lw - lmin) / span * 256.0
        maxlog = max(abs(lmin), abs(lmax), float(np.abs(lw[diff_mask]).max()))
        tol = 256.0 * 6.0 * float(np.spacing(np.float32(maxlog))) / span
    else:
        w = np.where(np.isposinf(m), vmax, np.where(np.isnan(m) | np.isneginf(m), vmin, m))
        bins64 = (w - vmin) / (vmax - vmin) * 256.0
        tol = max(1e-4, float(np.abs(bins64[diff_mask]).max()) * 6.0e-7)
    dist = np.abs(bins64 - np.rint(bins64))
    off_boundary = diff_mask & (dist > tol)
    assert not off_boundary.any(), (
        f"seed {seed}: {cfg['z_scale']}-z idx diverged {int(off_boundary.sum())} cells "
        f"AWAY from a bin boundary (min dist {float(dist[off_boundary].min()):.2e} > tol {tol:.2e})"
    )
    return False


@pytest.mark.parametrize("seed", range(64))
def test_fuzz_host_vs_device_quantize(seed, dev):
    """test_fuzz_parity.py::test_fuzz_host_vs_device_quantize: the port's device analysis against its
    numpy host analysis (the reference's normalize and percentile chain) over the seeded configurations."""
    cfg = _random_config(seed)
    T, E = cfg["matrix"].shape
    spec = S.RenderSpec(height=cfg["H"], width=cfg["W"], y_scale=cfg["y_scale"], z_scale=cfg["z_scale"],
                        low_percentile=cfg["low_pct"], high_percentile=cfg["high_pct"])
    zb_arr = np.array([np.nan if v is None else v for v in cfg["z_bounds"]], np.float32)
    out = S.quantize_matrix(
        _lane(cfg["matrix"], dev), _lane(cfg["energy"], dev), _lane(cfg["e_valid"], dev),
        torch.tensor([T], device=dev), torch.tensor([cfg["t_start"]], device=dev),
        torch.tensor([cfg["t_count"]], device=dev), _lane(zb_arr, dev), spec,
    )
    q = {k: _np(v)[0] for k, v in out.items()}
    try:
        host = host_quantize(cfg["matrix"], cfg["energy"], cfg["e_valid"], cfg["t_start"], cfg["t_count"],
                             cfg["z_bounds"], cfg["y_scale"], cfg["z_scale"], cfg["low_pct"], cfg["high_pct"])
    except ValueError as exc:
        # The host raises LogNorm's error where the safe floor exceeds an explicit log vmax; the device
        # analysis cannot raise, so its bounds must come out inverted for the drain to record the same error.
        assert "minvalue" in str(exc), f"seed {seed}: unexpected ValueError {exc}"
        assert cfg["z_scale"] == "log", f"seed {seed}: host raised outside log-z"
        assert not bool(q["empty"]), f"seed {seed}: device empty but host errored"
        assert float(q["vmin"]) > float(q["vmax"]), f"seed {seed}: device bounds not inverted"
        return
    assert bool(q["empty"]) == bool(host["empty"]), f"seed {seed}: empty flag diverged"
    if host["empty"]:
        return
    assert int(q["n_kept"]) == host["n_kept"], f"seed {seed}: n_kept"
    np.testing.assert_array_equal(q["kept_pos"][: host["n_kept"]], host["kept_pos"][: host["n_kept"]],
                                  err_msg=f"seed {seed}: kept_pos")
    assert bool(q["flip"]) == bool(host["flip"]), f"seed {seed}: flip"
    for k in ("y0", "y1"):
        np.testing.assert_allclose(float(q[k]), float(host[k]), rtol=1e-6, err_msg=f"seed {seed}: {k}")
    np.testing.assert_array_equal(np.float32(q["vmin"]), np.float32(host["vmin"]), err_msg=f"seed {seed}: vmin")
    np.testing.assert_array_equal(np.float32(q["vmax"]), np.float32(host["vmax"]), err_msg=f"seed {seed}: vmax")
    sel = np.zeros((T, E), bool)
    sel[cfg["t_start"]: cfg["t_start"] + cfg["t_count"], host["kept_pos"][: host["n_kept"]]] = True
    if not _assert_idx_parity(q["idx"], host["idx"], sel, cfg, host, seed):
        return  # a bin flip on a proven boundary: the tiles differ by that bin
    window = TimeWindow(cfg["t_start"], cfg["t_count"],
                        (float(cfg["t_start"]), float(cfg["t_start"] + max(cfg["t_count"] - 1, 0))),
                        (float(cfg["t_start"]), float(cfg["t_start"] + max(cfg["t_count"], 1))))
    x_map = make_x_map(window, cfg["W"])
    lut = colormap_lut(cfg["colormap"])
    tiles = [
        resample_indices(np.asarray(r["idx"]), np.asarray(r["kept_pos"]), int(r["n_kept"]), bool(r["flip"]),
                         float(r["y0"]), float(r["y1"]), cfg["t_start"], cfg["t_count"], x_map, cfg["H"], cfg["W"],
                         cfg["y_scale"], lut, empty=bool(r["empty"]))
        for r in (q, host)
    ]
    np.testing.assert_array_equal(tiles[0], tiles[1], err_msg=f"seed {seed}: rgba tile")


def test_host_backend_full_figure(monkeypatch, rng):
    """test_host_backend.py::test_host_backend_full_figure: host and device figures agree but for
    quantization boundaries (under 2% of the pixels)."""
    from configurable_spectrograms_torch.data.synthetic import synth_instrument_arrays
    from configurable_spectrograms_torch.render.plotting import generic_plot_multirow_optional_zoom

    a = synth_instrument_arrays(rng, n_time=80, n_angle=8, n_energy=16)
    ds = [{"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"], "label": "R"}]
    marks = [float(a["time_unix"][30]), float(a["time_unix"][50])]

    def render(mode):
        monkeypatch.setenv("CST_RENDER_BACKEND", mode)
        fig, _ = generic_plot_multirow_optional_zoom(ds, vertical_lines=marks, z_scale="log", colormap="inferno")
        return np.asarray(fig.render(dpi=60))

    host_img = render("host")
    dev_img = render("device")
    assert host_img.shape == dev_img.shape
    frac_diff = (host_img != dev_img).any(axis=-1).mean()
    assert frac_diff < 0.02, f"host/device figures diverge on {frac_diff:.4f} of pixels"


# ---------------------------------------------------------------------------
# tests/test_golden_figures.py: the goldens, on the host backend as there
# ---------------------------------------------------------------------------


def _golden_dataset(n_time=90, n_angle=6, n_energy=20):
    from configurable_spectrograms_torch.data.synthetic import synth_instrument_arrays

    return synth_instrument_arrays(np.random.default_rng(42), n_time=n_time, n_angle=n_angle, n_energy=n_energy)


def _render_multirow_zoom(y_scale="log", z_scale="log", colormap="inferno"):
    from configurable_spectrograms_torch.render.plotting import generic_plot_multirow_optional_zoom

    a = _golden_dataset()
    ds = [
        {"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"], "label": "EES"},
        {"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"] * 3.0, "label": "IES"},
    ]
    marks = [float(a["time_unix"][35]), float(a["time_unix"][55])]
    fig, _ = generic_plot_multirow_optional_zoom(ds, vertical_lines=marks, y_scale=y_scale, z_scale=z_scale,
                                                 colormap=colormap, cusp_marker_style="both", title="Golden multirow")
    return np.asarray(fig.render(dpi=60).convert("RGB"))


def _render_generic_set():
    from configurable_spectrograms_torch.render.plotting import generic_plot_spectrogram_set

    a = _golden_dataset(n_time=70, n_energy=16)
    ds = [{"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"], "label": "Row A"}]
    fig, _ = generic_plot_spectrogram_set(ds, y_scale="linear", z_scale="linear", colormap="viridis",
                                          figure_title="Golden set")
    return np.asarray(fig.render(dpi=60).convert("RGB"))


@pytest.fixture(scope="module")
def golden_archive(tmp_path_factory):
    """A deterministic one-orbit synthetic archive for the FAST-grid goldens."""
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("golden_fast")
    csv = root / "cusp.tsv"
    mapping = synth_fast_archive(str(root), [4242], n_time=120, n_angle=12, n_energy=24, cusp_csv_path=str(csv),
                                 seed=7)
    return {"mapping": mapping, "csv": str(csv)}


def _render_pitch_grid_200dpi(archive):
    from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_torch.fast.plotting import FAST_plot_pitch_angle_grid

    fig, _ = FAST_plot_pitch_angle_grid(archive["mapping"][4242]["ees"],
                                        filtered_orbits_df=load_filtered_orbits(archive["csv"]), orbit_number=4242,
                                        scale_function_y="log", scale_function_z="log", show=False,
                                        colormap="inferno")
    return np.asarray(fig.render(dpi=200).convert("RGB"))


def _render_instrument_grid_200dpi(archive):
    from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_torch.fast.plotting import FAST_plot_instrument_grid

    extrema = {}
    for inst in _INSTRUMENTS:
        extrema[f"{inst}_linear_log_y_max"] = 3000
        extrema[f"{inst}_linear_log_z_max"] = 1800.0
    fig, _ = FAST_plot_instrument_grid(archive["mapping"][4242], filtered_orbits_df=load_filtered_orbits(archive["csv"]),
                                       orbit_number=4242, scale_function_y="linear", scale_function_z="log",
                                       show=False, colormap="plasma", global_extrema=extrema)
    return np.asarray(fig.render(dpi=200).convert("RGB"))


def _compare_golden(name, img, tmp_path):
    golden_path = GOLDEN_DIR / f"{name}.png"
    golden = np.asarray(Image.open(golden_path).convert("RGB"))
    assert img.shape == golden.shape, f"figure geometry changed: {img.shape} vs {golden.shape}"
    diff = (img != golden).any(axis=-1)
    if diff.any():
        out = tmp_path / f"{name}_got.png"
        Image.fromarray(img).save(out)
        raise AssertionError(f"{diff.mean():.4%} of pixels differ from {golden_path.name}; render saved to {out}")


_COMBOS = [("linear", "linear", "viridis"), ("linear", "log", "cividis"), ("log", "linear", "plasma")]


@pytest.mark.parametrize(
    "name,render",
    [("multirow_zoom_log_log", _render_multirow_zoom), ("generic_set_linear", _render_generic_set)]
    + [(f"multirow_{y}_{z}", (lambda y=y, z=z, c=c: _render_multirow_zoom(y, z, c))) for y, z, c in _COMBOS],
)
def test_golden_figure(name, render, monkeypatch, tmp_path):
    """test_golden_figures.py::test_golden_figure"""
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    _compare_golden(name, render(), tmp_path)


@pytest.mark.parametrize("kind", ["pitch", "instrument"])
def test_golden_fast_grid_200dpi(kind, golden_archive, monkeypatch, tmp_path):
    """test_golden_figures.py::test_golden_fast_grid_200dpi"""
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    render = _render_pitch_grid_200dpi if kind == "pitch" else _render_instrument_grid_200dpi
    _compare_golden(f"fast_{kind}_grid_200dpi", render(golden_archive), tmp_path)


def test_golden_audio_mel(monkeypatch, tmp_path):
    """test_golden_figures.py::test_golden_audio_mel"""
    from configurable_spectrograms_torch.render.plotting import generic_plot_spectrogram_set

    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    rate = 8000
    t = np.arange(rate) / rate
    sig = np.sin(2 * np.pi * (200 + 1400 * t) * t).astype(np.float32)
    ds = tstft.audio_spectrogram_dataset(sig, rate, frame_length=256, hop_length=128, n_mels=48, label="Golden chirp")
    fig, _ = generic_plot_spectrogram_set([ds], x_is_unix=False, z_scale="log", colormap="magma",
                                          y_min=float(ds["y"][0]), y_max=float(ds["y"][-1]))
    _compare_golden("audio_mel_chirp", np.asarray(fig.render(dpi=72).convert("RGB")), tmp_path)


# ---------------------------------------------------------------------------
# tests/test_quantize_path.py: the light-readback path and the cube cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("y_scale,z_scale", [("linear", "linear"), ("linear", "log"), ("log", "linear"), ("log", "log")])
def test_host_resample_matches_device_render(rng, y_scale, z_scale, dev):
    """test_quantize_path.py::test_host_resample_matches_device_render"""
    T, E = 60, 20
    H, W = 48, 100
    matrix = (rng.random((T, E)) * 500).astype(np.float32)
    matrix[:, 7] = np.nan
    energy = np.geomspace(20000, 5, E).astype(np.float32)
    e_valid = (energy >= 0) & (energy <= 4000)
    window = TimeWindow(t_start=5, t_count=40, extent=(5.0, 44.0), xlim=(0.0, 50.0))
    x_map = make_x_map(window, W)
    z_bounds = np.array([np.nan, np.nan], np.float32)
    spec = S.RenderSpec(height=H, width=W, y_scale=y_scale, z_scale=z_scale)
    lut = colormap_lut("plasma")
    common = (_lane(matrix, dev), _lane(energy, dev), _lane(e_valid, dev), torch.tensor([T], device=dev),
              torch.tensor([window.t_start], device=dev), torch.tensor([window.t_count], device=dev))
    device = {k: _np(v)[0] for k, v in S.render_matrix(*common, _lane(x_map, dev), _lane(z_bounds, dev),
                                                        _lane(lut, dev), spec).items()}
    q = {k: _np(v)[0] for k, v in S.quantize_matrix(*common, _lane(z_bounds, dev), spec).items()}
    host_rgba = resample_indices(q["idx"], q["kept_pos"], int(q["n_kept"]), bool(q["flip"]), float(q["y0"]),
                                 float(q["y1"]), window.t_start, window.t_count, x_map, H, W, y_scale, lut,
                                 empty=bool(q["empty"]))
    np.testing.assert_array_equal(host_rgba, device["rgba"])
    np.testing.assert_allclose(float(q["vmin"]), float(device["vmin"]), rtol=1e-6)
    np.testing.assert_allclose(float(q["vmax"]), float(device["vmax"]), rtol=1e-6)


def test_pre_gather_path_matches_direct(rng, dev):
    """test_quantize_path.py::test_pre_gather_path_matches_direct: a long record (T >> W) renders through the
    dispatch's pre-gather with the pixels of the ungathered path (its collapse, then ``render_matrix``)."""
    T, A, E = 700, 6, 12
    cube = (rng.random((T, A, E)) * 300).astype(np.float32)
    energy = np.geomspace(4000, 10, E).astype(np.float32)
    window = TimeWindow(10, 600, (10.0, 609.0), (5.0, 615.0))
    panel = PanelData(cube=cube, pitch_mask=np.ones(A, bool), energy=energy, times=np.arange(T, dtype=np.float64),
                      window=window, y_min=0.0, y_max=4000.0, z_min=None, z_max=None, y_scale="log", z_scale="log",
                      colormap="inferno", x_is_unix=True, z_label="Counts")
    tile_h, tile_w = 40, 120  # Tp (768) > Wp (256): the gather is active
    gathered = dispatch.device_render_panels([panel], tile_h, tile_w)[0]
    spec = S.RenderSpec(height=tile_h, width=tile_w, y_scale="log", z_scale="log")
    m = S.collapse_cube(torch.from_numpy(cube).to(dev), torch.ones(A, dtype=torch.bool, device=dev), T)
    direct = S.render_matrix(
        m.unsqueeze(0), _lane(energy, dev), _lane((energy >= 0) & (energy <= 4000), dev),
        torch.tensor([T], device=dev), torch.tensor([10], device=dev), torch.tensor([600], device=dev),
        _lane(make_x_map(window, tile_w), dev), _lane(np.array([np.nan, np.nan], np.float32), dev),
        _lane(colormap_lut("inferno"), dev), spec,
    )
    np.testing.assert_array_equal(gathered["rgba"], _np(direct["rgba"])[0])


def test_device_cube_cache_reuse_and_eviction(monkeypatch, dev):
    """test_quantize_path.py::test_device_cube_cache_reuse_and_eviction: a repeat is a resident hit, a second
    geometry its own entry, the source's collection evicts every geometry, and the byte budget evicts FIFO."""
    import gc

    cache = device_cache.cube_cache(dev)
    cube = np.random.default_rng(0).random((32, 8, 16)).astype(np.float32)
    a1 = device_cache._padded_device_cube(cube, 32, 8, 16, dev)
    a2 = device_cache._padded_device_cube(cube, 32, 8, 16, dev)
    assert a1 is a2  # resident hit, no second upload
    a3 = device_cache._padded_device_cube(cube, 64, 8, 16, dev)
    assert a3 is not a1 and tuple(a3.shape) == (64, 8, 16)
    np.testing.assert_array_equal(_np(a1), np.where(np.isnan(cube), np.nan, cube))
    assert cache.total_bytes == a1.nbytes + a3.nbytes
    del cube, a1, a2, a3
    gc.collect()
    assert cache.total_bytes == 0
    assert not len(cache)
    monkeypatch.setenv("CST_DEVICE_CUBE_CACHE_BYTES", str(int(32 * 8 * 16 * 4 * 1.5)))
    c1 = np.zeros((32, 8, 16), np.float32)
    c2 = np.ones((32, 8, 16), np.float32)
    device_cache._padded_device_cube(c1, 32, 8, 16, dev)
    device_cache._padded_device_cube(c2, 32, 8, 16, dev)
    assert [k[0] for k in cache.keys()] == [id(c2)]  # c1 evicted FIFO


# ---------------------------------------------------------------------------
# this module imports neither jax nor the JAX package
# ---------------------------------------------------------------------------

_BLOCKED = ("jax", "jaxlib", "configurable_spectrograms_tpu")

_BLOCKED_IMPORT = """
import importlib.abc, importlib.util, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError(name + " is blocked")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {tests!r})
spec = importlib.util.spec_from_file_location("assertions", {path!r})
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
tests = [n for n in vars(module) if n.startswith("test_")]
print(len(tests), sorted({{m.split(".")[0] for m in sys.modules}} & set({blocked!r})))
"""


def test_the_module_imports_neither_jax_nor_the_jax_package():
    """No import of ``jax``, ``jaxlib`` or ``configurable_spectrograms_tpu`` anywhere in this file's source, and
    the module loads in a process where those imports raise, holding every test."""
    tree = ast.parse(Path(__file__).read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.split(".")[0])
    assert not imported & set(_BLOCKED), imported & set(_BLOCKED)
    code = _BLOCKED_IMPORT.format(blocked=_BLOCKED, tests=str(Path(__file__).parent), path=__file__)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_tests, loaded = proc.stdout.split(maxsplit=1)
    assert int(n_tests) == sum(1 for n in vars(sys.modules[__name__]) if n.startswith("test_"))
    assert loaded.strip() == "[]"
