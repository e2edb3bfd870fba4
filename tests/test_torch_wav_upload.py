"""The audio CLI's int16 path: a 16-bit mono WAV read into a host tensor, copied to the device and widened there.

On the CPU the widened tensor must be :func:`cli.audio.load_wav`'s float32
array bit for bit, whatever the file's chunks and length; every other WAV
(8-bit, 32-bit, stereo), and any WAV on the host back end, must take
``load_wav``'s path, record no ``pcm_upload`` stage and draw the pixels the
float32 path draws.  On a card (``-m cuda``) two recordings rendered back to
back, twice over, must each give the host back end's spectrogram of its
own file, so no figure reads samples of another from a reused pinned block.
"""

import struct
import wave

import numpy as np
import pytest
import torch

from configurable_spectrograms_torch.cli import audio

torch.set_num_threads(1)

RATE = 8000


def _pcm(n: int, seed: int) -> np.ndarray:
    """Seeded int16 samples spanning the whole range, both extremes included."""
    x = np.random.default_rng(seed).integers(-32768, 32768, size=n, dtype=np.int16)
    x[:2] = (-32768, 32767)
    return x


def _riff(path, data: bytes, *, before_data: bytes = b"", declared: int | None = None) -> None:
    """A 16-bit mono PCM WAV written chunk by chunk: *before_data* goes between ``fmt `` and ``data``."""
    fmt = struct.pack("<HHIIHH", 1, 1, RATE, 2 * RATE, 2, 16)
    size = len(data) if declared is None else declared
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + before_data
    body += b"data" + struct.pack("<I", size) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _list_chunk() -> bytes:
    info = b"INFOISFT" + struct.pack("<I", 6) + b"probe\0"
    return b"LIST" + struct.pack("<I", len(info)) + info


def _plain(path):
    _riff(path, _pcm(4000, 1).tobytes())


def _list_before_data(path):
    _riff(path, _pcm(3000, 2).tobytes(), before_data=_list_chunk())


def _odd_frame_count(path):
    _riff(path, _pcm(2999, 3).tobytes())


def _data_shorter_than_its_header(path):
    _riff(path, _pcm(1000, 4).tobytes(), declared=2 * 4096)


def _shorter_than_one_frame(path):
    _riff(path, _pcm(500, 5).tobytes())


def _no_samples(path):
    _riff(path, b"")


@pytest.mark.parametrize("write", [_plain, _list_before_data, _odd_frame_count, _data_shorter_than_its_header,
                                   _shorter_than_one_frame, _no_samples], ids=lambda f: f.__name__.strip("_"))
def test_widened_samples_are_load_wavs_bit_for_bit(write, tmp_path, monkeypatch):
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    path = str(tmp_path / "in.wav")
    write(path)
    got, rate = audio.load_pcm16_on_device(path)
    want, want_rate = audio.load_wav(path)
    assert rate == want_rate == RATE
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), torch.from_numpy(want).view(torch.int32))


def _wav(path, width: int, channels: int) -> None:
    """0.5 s of a chirp and noise at *width* bytes a sample, written by the stdlib ``wave``."""
    n = RATE // 2
    t = np.arange(n) / RATE
    sig = 0.5 * np.sin(2 * np.pi * (200 + 2500 * t) * t) + 0.05 * np.random.default_rng(width).standard_normal(n)
    sig = np.repeat(sig[:, None], channels, axis=1) * (1.0, 0.4)[:channels]
    if width == 1:
        raw = np.round(128 + 127 * sig).astype(np.uint8)
    else:
        raw = np.round(sig * (2 ** (8 * width - 1) - 1)).astype(f"<i{width}")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(RATE)
        w.writeframes(raw.tobytes())


def _pixels(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("width, channels, backend, uploads", [(2, 1, "device", 1), (1, 1, "device", 0),
                                                              (4, 1, "device", 0), (2, 2, "device", 0),
                                                              (2, 1, "host", 0)],
                         ids=["pcm16-mono", "pcm8", "pcm32", "pcm16-stereo", "pcm16-mono-host"])
def test_only_16_bit_mono_on_the_device_takes_the_int16_path(width, channels, backend, uploads, tmp_path,
                                                              monkeypatch):
    from configurable_spectrograms_torch.utils import timing

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    wav = tmp_path / "in.wav"
    _wav(wav, width, channels)
    timer = timing.ACTIVE = timing.StageTimer("test")
    try:
        assert audio.render_audio_spectrogram(str(wav), str(tmp_path / "new.png"), 256, 64, n_mels=24)
    finally:
        timing.ACTIVE = None
    assert timer.counts.get("pcm_upload", 0) == uploads and timer.counts["wav_load"] == 1
    monkeypatch.setattr(audio, "load_pcm16_on_device", lambda path: None)  # the float32 path alone
    assert audio.render_audio_spectrogram(str(wav), str(tmp_path / "float32.png"), 256, 64, n_mels=24)
    assert np.array_equal(_pixels(tmp_path / "new.png"), _pixels(tmp_path / "float32.png"))


@pytest.mark.cuda
def test_back_to_back_recordings_each_get_their_own_samples_on_the_card(tmp_path, monkeypatch):
    """Two recordings, A B A B, through the CLI's path: each figure's mel rows are the host back end's of its file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from configurable_spectrograms_torch.ops import stft
    from configurable_spectrograms_torch.utils import timing

    monkeypatch.setenv("CST_TORCH_DEVICE", "cuda")
    rate, n = 32000, 32000 * 30
    t = np.arange(n) / rate
    paths = [str(tmp_path / "tone.wav"), str(tmp_path / "noise.wav")]
    signals = [0.6 * np.sin(2 * np.pi * 440.0 * t), 0.3 * np.random.default_rng(9).standard_normal(n)]
    for path, sig in zip(paths, signals):
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(np.clip(np.round(sig * 32767), -32768, 32767).astype("<i2").tobytes())

    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    want = [stft.audio_spectrogram_dataset(*audio.load_wav(p), 1024, 320, n_mels=64)["data"] for p in paths]
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    got, real = [], audio.audio_spectrogram_dataset

    def keep(*a, **k):
        ds = real(*a, **k)
        got.append(np.array(ds["data"]))
        return ds

    monkeypatch.setattr(audio, "audio_spectrogram_dataset", keep)
    timer = timing.ACTIVE = timing.StageTimer("test")
    try:
        for k, path in enumerate(paths * 2):
            assert audio.render_audio_spectrogram(path, str(tmp_path / f"f{k}.png"), 1024, 320, n_mels=64)
    finally:
        timing.ACTIVE = None
    assert timer.counts["pcm_upload"] == 4
    for k, data in enumerate(got):
        ref = want[k % 2]
        assert data.shape == ref.shape
        np.testing.assert_allclose(data, ref, atol=5e-4 * np.abs(ref).max(), rtol=1e-3, err_msg=f"figure {k}")
