"""Audio STFT / mel-spectrogram front end (port of ``ops/stft.py``).

A windowed STFT (and optional mel projection) turns audio into a
(frames, 1, freq) cube that flows through the same collapse / percentile /
quantize / render pipeline as FAST data.  Framing is ``x.unfold(0, L,
hop)``, a view with row stride ``hop`` (no (F, L) copy); the three device
methods keep the JAX package's names:

- ``"fft"``: window multiply + ``torch.fft.rfft``.
- ``"matmul"``: the frames times the two window-folded DFT bases with
  ``torch.matmul`` (TF32 off), then ``re^2 + im^2``.
- ``"pallas"``: the same window-folded DFT as one hand-written CUDA kernel
  (:func:`..ops.kernels.stft_power`, ``csrc/stft_power.cu``) that reads the
  frames straight from the signal; on CPU tensors its plain version.  The
  name stays so scripts passing ``--stft-method pallas`` run unchanged.
  Unlike the JAX package there is no switch to ``matmul`` above
  ``frame_length`` 4096 (that was a TPU VMEM limit; the kernel streams L
  through shared memory) and no padding of F and K to 128 (the kernel
  masks its own edges).

The bases, window and filterbank come from the same float64 numpy code as
the JAX package's, bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

METHODS = ("fft", "matmul", "pallas")


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown stft method {method!r} (expected 'fft', 'matmul', or 'pallas')")


def hann_window(length: int) -> np.ndarray:
    """Periodic Hann window (the STFT convention)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(length) / length)).astype(np.float32)


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Overlapping frames of a 1D signal: (N,) -> (F, frame_length), a strided view."""
    if x.shape[0] < frame_length:
        return x.new_zeros((0, frame_length))
    return x.unfold(0, frame_length, hop_length)


@functools.lru_cache(maxsize=8)
def _dft_bases(frame_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis matrices (L, L//2+1) float32, the window folded in."""
    n = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(frame_length // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / frame_length
    w = hann_window(frame_length).astype(np.float64)[:, None]
    return (np.cos(ang) * w).astype(np.float32), (-np.sin(ang) * w).astype(np.float32)


def stft_magnitude(
    x,
    frame_length: int = 1024,
    hop_length: int = 256,
    power: float = 2.0,
    method: str = "fft",
) -> torch.Tensor:
    """Windowed-STFT magnitude spectrogram: (N,) -> (frames, n_fft//2 + 1) float32.

    *x* is a 1D tensor (or array) on the device the work runs on; see the
    module docstring for the three methods.  A signal shorter than one
    frame gives ``(0, frame_length // 2 + 1)``, as in the JAX package,
    without a transform or a launch (an FFT of no frames raises in MKL).
    """
    _check_method(method)
    x = torch.as_tensor(x, dtype=torch.float32)
    frames = frame_signal(x, frame_length, hop_length)
    if frames.shape[0] == 0:
        return x.new_zeros((0, frame_length // 2 + 1))
    if method == "fft":
        window = torch.from_numpy(hann_window(frame_length)).to(x.device)
        mag = torch.fft.rfft(frames * window, dim=-1).abs()
        return mag if power == 1.0 else torch.pow(mag, power)
    cos_b, sin_b = (torch.from_numpy(b).to(x.device) for b in _dft_bases(frame_length))
    if method == "pallas":
        from configurable_spectrograms_torch.ops.kernels import stft_power

        p2 = stft_power(frames, cos_b, sin_b)
    else:
        re = frames @ cos_b
        im = frames @ sin_b
        p2 = re * re + im * im
    if power == 2.0:
        return p2
    mag = torch.sqrt(p2)
    return mag if power == 1.0 else torch.pow(mag, power)


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """HTK mel scale: ``2595 * log10(1 + f/700)``."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_mels: int,
    n_fft: int,
    sample_rate: float,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Triangular HTK mel filterbank.

    Returns ``(weights (n_fft//2+1, n_mels) float32, center_freqs (n_mels,))``.
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    weights = np.zeros((n_freq, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        weights[:, m] = np.maximum(0.0, np.minimum(up, down))
    return weights, hz_pts[1:-1].astype(np.float32)


def mel_spectrogram(
    x,
    sample_rate: int,
    frame_length: int = 1024,
    hop_length: int = 256,
    n_mels: int = 128,
    power: float = 2.0,
    method: str = "fft",
) -> torch.Tensor:
    """Mel spectrogram: (N,) -> (frames, n_mels); the projection is ``torch.matmul``."""
    mag = stft_magnitude(x, frame_length=frame_length, hop_length=hop_length, power=power, method=method)
    weights, _ = mel_filterbank(n_mels, frame_length, float(sample_rate))
    return mag @ torch.from_numpy(weights).to(mag.device)


def host_stft_magnitude(
    x: np.ndarray, frame_length: int = 1024, hop_length: int = 256, power: float = 2.0
) -> np.ndarray:
    """Numpy STFT with the ``"fft"`` method's math: the host backend's STFT."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    num_frames = max(0, 1 + (n - frame_length) // hop_length)
    starts = np.arange(num_frames) * hop_length
    frames = x[starts[:, None] + np.arange(frame_length)[None, :]]
    mag = np.abs(np.fft.rfft(frames * hann_window(frame_length), axis=-1)).astype(np.float32)
    return mag if power == 1.0 else np.power(mag, np.float32(power))


def audio_spectrogram_dataset(
    signal: np.ndarray,
    sample_rate: int,
    frame_length: int = 1024,
    hop_length: int = 256,
    n_mels: int | None = None,
    power: float = 2.0,
    label: str | None = None,
    method: str = "fft",
) -> dict:
    """Build a ``generic_plot_spectrogram_set`` dataset dict from audio.

    The (frames, freq) spectrogram becomes a (time, 1, freq) cube; ``x`` is
    frame-centre seconds (``x_is_unix=False`` at plot time), ``y`` is Hz
    (FFT bins) or mel centre frequencies.  ``CST_RENDER_BACKEND=host``
    computes the STFT in numpy (:func:`host_stft_magnitude`); ``device``
    computes it with torch on :func:`..utils.torch_setup.get_device`, and a
    CUDA error raises (no fallback to the host).
    """
    from configurable_spectrograms_torch.render.backend import render_backend

    _check_method(method)
    weights = None
    if n_mels is not None:
        weights, centers = mel_filterbank(n_mels, frame_length, float(sample_rate))
        freqs = centers
    else:
        freqs = np.linspace(0.0, sample_rate / 2.0, frame_length // 2 + 1).astype(np.float32)

    if render_backend() == "host":
        spec_np = host_stft_magnitude(signal, frame_length, hop_length, power)
        if weights is not None:
            spec_np = spec_np @ weights
    else:
        from configurable_spectrograms_torch.utils.torch_setup import get_device

        x = torch.from_numpy(np.ascontiguousarray(signal, np.float32)).to(get_device())
        if n_mels is not None:
            spec = mel_spectrogram(x, sample_rate, frame_length, hop_length, n_mels, power, method)
        else:
            spec = stft_magnitude(x, frame_length, hop_length, power, method)
        spec_np = spec.cpu().numpy()
    frames = spec_np.shape[0]
    times = (np.arange(frames) * hop_length + frame_length / 2) / float(sample_rate)
    return {
        "x": times,
        "y": freqs,
        "data": spec_np[:, None, :],
        "label": label or ("Mel spectrogram" if n_mels else "STFT spectrogram"),
        "x_label": "Time (s)",
        "y_label": "Frequency (Hz)",
        "z_label": "Power",
    }
