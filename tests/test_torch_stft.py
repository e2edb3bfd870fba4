"""The audio STFT front end of the port against the JAX package, on the CPU.

The same seeded numpy signals go through ``configurable_spectrograms_tpu.ops.stft``
and ``configurable_spectrograms_torch.ops.stft``.  The bases, window,
filterbank, framing and the host STFT are bit-identical; the device methods
agree within the tolerances of tests/test_stft.py; the plain version of the
STFT-power kernel agrees with the Pallas kernel run in interpret mode; and
the audio golden comes out of the port pixel for pixel.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from configurable_spectrograms_tpu.ops import stft as jstft
from configurable_spectrograms_torch.ops import kernels as K
from configurable_spectrograms_torch.ops import stft as tstft

GOLDEN = Path(__file__).resolve().parent / "goldens" / "audio_mel_chirp.png"

torch.set_num_threads(1)


def _signal(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000.0
    chirp = 0.5 * np.sin(2 * np.pi * (100 + 900 * t) * t)
    return (chirp + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _within_kernel_tolerance(a: np.ndarray, b: np.ndarray) -> None:
    """``|a - b| <= 1e-4 * max(|a|, 1e-3 * max|a|) + 1e-2`` (tests/test_stft.py:243-244)."""
    scale = np.maximum(np.abs(a), 1e-3 * np.abs(a).max())
    assert np.all(np.abs(a - b) <= 1e-4 * scale + 1e-2), float((np.abs(a - b) / (1e-4 * scale + 1e-2)).max())


@pytest.mark.parametrize("L", [64, 256, 1024])
def test_bases_and_window_are_bit_identical(L):
    for mine, ref in zip(tstft._dft_bases(L), jstft._dft_bases(L)):
        assert mine.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(tstft.hann_window(L), jstft.hann_window(L))


@pytest.mark.parametrize("n_mels,n_fft,rate", [(48, 256, 8000.0), (128, 1024, 44100.0), (40, 512, 16000.0)])
def test_mel_filterbank_is_bit_identical(n_mels, n_fft, rate):
    w, c = tstft.mel_filterbank(n_mels, n_fft, rate)
    jw, jc = jstft.mel_filterbank(n_mels, n_fft, rate)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(c, jc)
    f = np.array([0.0, 440.0, 8000.0])
    np.testing.assert_array_equal(tstft.hz_to_mel(f), jstft.hz_to_mel(f))
    np.testing.assert_array_equal(tstft.mel_to_hz(f), jstft.mel_to_hz(f))


@pytest.mark.parametrize("n,L,hop", [(1000, 256, 64), (4096, 512, 160), (300, 256, 128), (100, 256, 64)])
def test_framing_is_bit_identical_and_a_view(n, L, hop):
    x = _signal(n, 1)
    xt = torch.from_numpy(x)
    frames = tstft.frame_signal(xt, L, hop)
    want = np.asarray(jstft.frame_signal(x, L, hop))
    assert tuple(frames.shape) == want.shape
    np.testing.assert_array_equal(frames.numpy(), want)
    if frames.shape[0]:
        assert frames.stride() == (hop, 1) and frames.data_ptr() == xt.data_ptr()  # no (F, L) copy


@pytest.mark.parametrize("F", [122, 256])
@pytest.mark.parametrize("L", [256, 512, 1024])
def test_stft_power_plain_matches_the_pallas_kernel(F, L):
    """The plain version against ``stft_power_pallas(interpret=True)``, padded as stft.py:85-95 pads."""
    from configurable_spectrograms_tpu.ops.pallas_kernels import stft_power_pallas

    hop = L // 4
    x = _signal((F - 1) * hop + L, seed=F + L)
    frames = tstft.frame_signal(torch.from_numpy(x), L, hop)
    assert frames.shape[0] == F
    cos_b, sin_b = tstft._dft_bases(L)
    got = K.stft_power(frames, torch.from_numpy(cos_b), torch.from_numpy(sin_b)).numpy()
    plain = K.stft_power_plain(frames, torch.from_numpy(cos_b), torch.from_numpy(sin_b)).numpy()
    np.testing.assert_array_equal(got, plain)  # CPU tensors take the plain version
    Kb = cos_b.shape[1]
    Fp, Kp = -(-F // 128) * 128, -(-Kb // 128) * 128
    frames_p = np.pad(frames.numpy(), ((0, Fp - F), (0, 0)))
    want = np.asarray(stft_power_pallas(frames_p, np.pad(cos_b, ((0, 0), (0, Kp - Kb))),
                                        np.pad(sin_b, ((0, 0), (0, Kp - Kb))), 128, 128, interpret=True))[:F, :Kb]
    assert got.shape == want.shape
    _within_kernel_tolerance(want, got)


@pytest.mark.parametrize("method", ["fft", "matmul", "pallas"])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_magnitude_matches_jax_per_method(method, power):
    x = _signal(6000, 5)
    got = tstft.stft_magnitude(torch.from_numpy(x), 256, 64, power, method).numpy()
    want = np.asarray(jstft.stft_magnitude(x, 256, 64, power, method))
    assert got.shape == want.shape and got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize("method", ["fft", "matmul", "pallas"])
def test_signal_shorter_than_one_frame_gives_no_frames(method, monkeypatch):
    """(0, L//2 + 1) float32 as in the JAX package (tests/test_compositor.py::test_stft_empty_signal),
    with no transform and no kernel call."""
    def refuse(*args, **kwargs):
        raise AssertionError("no frames: nothing to transform")

    x = _signal(16, 2)
    want = np.asarray(jstft.stft_magnitude(x, 32, 8, 2.0, method))
    monkeypatch.setattr(torch.fft, "rfft", refuse)
    monkeypatch.setattr(K, "stft_power", refuse)
    got = tstft.stft_magnitude(torch.from_numpy(x), 32, 8, 2.0, method)
    assert tuple(got.shape) == want.shape == (0, 17)
    assert got.dtype == torch.float32 and want.dtype == np.float32 and got.device == torch.device("cpu")
    assert tuple(tstft.mel_spectrogram(torch.from_numpy(x), 8000, 32, 8, 4, 2.0, method).shape) == (0, 4)


@pytest.mark.parametrize("method", ["fft", "matmul", "pallas"])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_mel_spectrogram_matches_jax_per_method(method, power):
    x = _signal(6000, 6)
    got = tstft.mel_spectrogram(torch.from_numpy(x), 8000, 256, 64, 32, power, method).numpy()
    want = np.asarray(jstft.mel_spectrogram(x, 8000, 256, 64, 32, power, method))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=1e-3)


def test_pallas_method_runs_past_the_jax_frame_length_gate(monkeypatch):
    """No switch to ``matmul`` above L = 4096: the pallas method reaches stft_power."""
    calls = []
    real = K.stft_power
    monkeypatch.setattr(K, "stft_power", lambda *a: calls.append(a[0].shape) or real(*a))
    x = _signal(8192 + 3 * 2048, 7)
    got = tstft.stft_magnitude(torch.from_numpy(x), 8192, 2048, 2.0, "pallas")
    assert calls == [(4, 8192)] and tuple(got.shape) == (4, 4097)
    want = tstft.stft_magnitude(torch.from_numpy(x), 8192, 2048, 2.0, "matmul")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_host_stft_magnitude_is_bit_equal(power):
    x = _signal(5000, 8)
    np.testing.assert_array_equal(tstft.host_stft_magnitude(x, 512, 128, power),
                                  jstft.host_stft_magnitude(x, 512, 128, power))


@pytest.mark.parametrize("n_mels", [None, 24])
def test_audio_dataset_host_backend_is_bit_equal(n_mels, monkeypatch):
    from configurable_spectrograms_tpu.render import figure as jfigure

    monkeypatch.setitem(jfigure._BACKEND, "mode", "host")
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    x = _signal(4000, 9)
    got = tstft.audio_spectrogram_dataset(x, 8000, 256, 128, n_mels=n_mels, label="a")
    want = jstft.audio_spectrogram_dataset(x, 8000, 256, 128, n_mels=n_mels, label="a")
    assert set(got) == set(want)
    for k in got:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("method", ["fft", "matmul", "pallas"])
@pytest.mark.parametrize("n_mels", [None, 24])
def test_audio_dataset_device_backend_matches_jax(method, n_mels, monkeypatch):
    from configurable_spectrograms_tpu.render import figure as jfigure

    monkeypatch.setitem(jfigure._BACKEND, "mode", "device")
    monkeypatch.setitem(jfigure._BACKEND, "forced_host", False)
    monkeypatch.setitem(jfigure._BACKEND, "probed", True)
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    x = _signal(4000, 10)
    got = tstft.audio_spectrogram_dataset(x, 8000, 256, 128, n_mels=n_mels, method=method)
    want = jstft.audio_spectrogram_dataset(x, 8000, 256, 128, n_mels=n_mels, method=method)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["data"].shape == want["data"].shape and got["data"].shape[1] == 1
    assert got["label"] == want["label"]
    scale = np.abs(want["data"]).max()
    np.testing.assert_allclose(got["data"], want["data"], atol=5e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_audio_dataset_rejects_a_bad_method_on_both_backends(backend, monkeypatch):
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    with pytest.raises(ValueError, match="unknown stft method"):
        tstft.audio_spectrogram_dataset(_signal(1000, 0), 8000, method="bogus")
    with pytest.raises(ValueError, match="unknown stft method"):
        tstft.stft_magnitude(torch.zeros(512), 256, 64, method="welch")


def test_audio_dataset_on_a_missing_card_raises(monkeypatch):
    """``CST_TORCH_DEVICE=cuda`` without a card raises; nothing falls back to the host."""
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    monkeypatch.setenv("CST_TORCH_DEVICE", "cuda")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tstft.audio_spectrogram_dataset(_signal(1000, 0), 8000, 256, 64)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_golden_audio_mel_through_the_port(backend, monkeypatch):
    """tests/goldens/audio_mel_chirp.png from the port (inputs of test_golden_figures.py:171-189).

    Host backend: the port's own dataset and render, pixel for pixel.  Device
    backend (torch on the CPU): the host-computed dataset, so only the render
    backend differs -- the same pixels as the JAX package's device backend,
    which differs from the golden in the colorbar's log ticks because the
    device holds the 1e-10 floor of vmin in float32.
    """
    from PIL import Image

    from configurable_spectrograms_tpu.render import figure as jfigure
    from configurable_spectrograms_tpu.render.plotting import generic_plot_spectrogram_set as jplot
    from configurable_spectrograms_torch.render.plotting import generic_plot_spectrogram_set

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    rate = 8000
    t = np.arange(rate) / rate
    sig = np.sin(2 * np.pi * (200 + 1400 * t) * t).astype(np.float32)
    ds = tstft.audio_spectrogram_dataset(sig, rate, frame_length=256, hop_length=128, n_mels=48,
                                         label="Golden chirp")
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    kw = dict(x_is_unix=False, z_scale="log", colormap="magma", y_min=float(ds["y"][0]), y_max=float(ds["y"][-1]))
    fig, _ = generic_plot_spectrogram_set([ds], **kw)
    img = np.asarray(fig.render(dpi=72).convert("RGB"))
    if backend == "host":
        want = np.asarray(Image.open(GOLDEN).convert("RGB"))
    else:
        monkeypatch.setitem(jfigure._BACKEND, "mode", "device")
        monkeypatch.setitem(jfigure._BACKEND, "forced_host", False)
        monkeypatch.setitem(jfigure._BACKEND, "probed", True)
        jfig, _ = jplot([ds], **kw)
        want = np.asarray(jfig.render(dpi=72).convert("RGB"))
    assert img.shape == want.shape
    assert not (img != want).any(axis=-1).any(), f"{(img != want).any(axis=-1).mean():.4%} of pixels differ"


def test_wrapper_rejects_frames_the_kernel_does_not_take():
    x = torch.from_numpy(_signal(4096, 2))
    cos_b, sin_b = (torch.from_numpy(b) for b in tstft._dft_bases(256))
    frames = tstft.frame_signal(x, 256, 64)
    with pytest.raises(ValueError, match="unit inner stride"):
        K.stft_power(x[::2].unfold(0, 256, 64), cos_b, sin_b)
    with pytest.raises(ValueError, match="unit inner stride"):
        K.stft_power(frames.t().contiguous().t(), cos_b, sin_b)
    with pytest.raises(ValueError):
        K.stft_power(frames.double(), cos_b, sin_b)
    with pytest.raises(ValueError):
        K.stft_power(frames, cos_b[:-1], sin_b[:-1])
    with pytest.raises(ValueError):
        K.stft_power(frames, cos_b, sin_b[:, :-1])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = dict(K.LAUNCHES)
    x = torch.from_numpy(_signal(3000, 3))
    for method in ("pallas", "matmul", "fft"):
        tstft.stft_magnitude(x, 256, 64, 2.0, method)
    assert K.LAUNCHES == before and "stft_power" in K.LAUNCHES


def _tolerance_ratio(ref: np.ndarray, got: np.ndarray) -> float:
    """Largest ``|got - ref| / (1e-4 * max(|ref|, 1e-3 * max|ref|) + 1e-2)``: <= 1 passes."""
    scale = np.maximum(np.abs(ref), 1e-3 * np.abs(ref).max())
    return float((np.abs(got.astype(np.float64) - ref) / (1e-4 * scale + 1e-2)).max())


@pytest.mark.parametrize("L", [256, 1000, 1024])
def test_tf32_split_of_the_bases(L):
    """hi + lo gives back the bases to 2^-21 relative; each part keeps at most 11 significant bits."""
    for b in (torch.from_numpy(x) for x in tstft._dft_bases(L)):
        hi, lo = K.tf32_split(b)
        for part in (hi, lo):
            assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0  # 13 low mantissa bits clear
        rebuilt = hi.double() + lo.double()
        assert float(((rebuilt - b.double()).abs() / b.double().abs().clamp_min(1e-30)).max()) <= 2.0 ** -21
        assert torch.equal(hi, K.tf32_round(b)) and torch.equal(K.tf32_round(hi), hi)


@pytest.mark.parametrize("L", [256, 1000])
def test_stft_bases_t_layout(L):
    """(4, Kp, Lp): cos hi, cos lo, sin hi, sin lo, bins x samples, zero-padded to multiples of 16."""
    cos_b, sin_b = (torch.from_numpy(x) for x in tstft._dft_bases(L))
    Kb = cos_b.shape[1]
    bt = K.stft_bases_t(cos_b, sin_b)
    Kp, Lp = -(-Kb // 16) * 16, -(-L // 16) * 16
    assert tuple(bt.shape) == (4, Kp, Lp) and bt.is_contiguous()
    for i, part in enumerate((*K.tf32_split(cos_b), *K.tf32_split(sin_b))):
        assert torch.equal(bt[i, :Kb, :L], part.t())
    assert not bt[:, Kb:, :].any() and not bt[:, :, L:].any()


def _emulated_tf32_power(frames: np.ndarray, cos_b: np.ndarray, sin_b: np.ndarray, terms: int) -> np.ndarray:
    """The kernel's arithmetic in numpy: TF32 operands, each k8 step's products summed, then
    one rounded float32 add into the running sum.  ``terms=3`` is the kernel's split
    (lo*hi + hi*lo + hi*hi), ``terms=1`` plain TF32 (hi*hi)."""
    f_hi, f_lo = (t.numpy().astype(np.float64) for t in K.tf32_split(torch.from_numpy(frames)))
    out = []
    for b in (cos_b, sin_b):
        b_hi, b_lo = (t.numpy().astype(np.float64) for t in K.tf32_split(torch.from_numpy(b)))
        acc = np.zeros((frames.shape[0], b.shape[1]), np.float32)
        for k in range(0, frames.shape[1], 8):
            s = slice(k, k + 8)
            step = f_hi[:, s] @ b_hi[s]
            if terms == 3:
                step = f_lo[:, s] @ b_hi[s] + f_hi[:, s] @ b_lo[s] + step
            acc = acc + step.astype(np.float32)
        out.append(acc)
    re, im = out
    return re * re + im * im


def test_3xtf32_emulation_stays_within_the_tolerance_and_1xtf32_does_not():
    """Why the kernel splits: at F = 64, L = 1024 on seeded 16-bit audio, three TF32 products
    stay well inside the plain version's tolerance; one TF32 product does not."""
    L, hop, F = 1024, 256, 64
    rng = np.random.default_rng(12)
    t = np.arange((F - 1) * hop + L) / 44100.0
    x = 0.3 * np.sin(2 * np.pi * (50.0 + 3000.0 * t) * t) + 0.2 * np.sin(2 * np.pi * 440.0 * t)
    x = np.round((x + 0.01 * rng.standard_normal(t.size)) * 32767.0).astype(np.float32) / 32768.0
    frames = tstft.frame_signal(torch.from_numpy(x), L, hop)
    cos_b, sin_b = tstft._dft_bases(L)
    plain = K.stft_power_plain(frames, torch.from_numpy(cos_b), torch.from_numpy(sin_b)).numpy()
    frames = np.ascontiguousarray(frames.numpy())
    assert _tolerance_ratio(plain, _emulated_tf32_power(frames, cos_b, sin_b, terms=3)) < 0.5
    assert _tolerance_ratio(plain, _emulated_tf32_power(frames, cos_b, sin_b, terms=1)) > 1.0


@pytest.mark.cuda
def test_cuda_stft_power_matches_its_plain_version():
    """On a card: the kernel against its plain version (chip_smoke.py does this at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    get_device()  # TF32 off for the plain version's matmuls
    # The CLI default, past the JAX gate, hops that are not a multiple of 4 (4-byte
    # copies), an L tail (L % 16 != 0); F and K off every tile multiple.
    for L, hop, n in ((1024, 256, 200_000), (8192, 2048, 100_000), (200, 70, 9_999), (1000, 250, 60_000),
                      (1000, 200, 60_000), (998, 256, 30_000)):
        x = torch.from_numpy(_signal(n, L)).cuda()
        frames = tstft.frame_signal(x, L, hop)
        cos_b, sin_b = (torch.from_numpy(b).cuda() for b in tstft._dft_bases(L))
        before = K.LAUNCHES["stft_power"]
        got = K.stft_power(frames, cos_b, sin_b)
        assert K.LAUNCHES["stft_power"] == before + 1
        want = K.stft_power_plain(frames, cos_b, sin_b)
        _within_kernel_tolerance(want.cpu().numpy(), got.cpu().numpy())
        fd = frames.double()
        ref = (fd @ cos_b.double()) ** 2 + (fd @ sin_b.double()) ** 2
        # 3xTF32 keeps fp32 quality: within 4x the plain version's error against float64.
        assert float((got.double() - ref).abs().max()) <= 4.0 * float((want.double() - ref).abs().max())
