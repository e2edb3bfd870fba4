"""The audio CLI's spectrogram worked out again from the WAV's samples, in plain numpy.

The reference ``single_plot_audio_spectrogram.py``'s defaults: a periodic
Hann window of 1024 samples every 256, the power of the real FFT (in
float64, returned as float32), frame-centre times, bin frequencies from 0
to half the rate, a linear frequency axis and a log colour scale over the
1st-99th percentile, magma, 150 DPI.
"""

from __future__ import annotations

import wave

import numpy as np

from reference import panel
from reference.judge import Figure

FRAME, HOP, DPI, COLORMAP = 1024, 256, 150, "magma"
BLOCK = 8192  # frames per FFT block, to bound the reference's memory


def load(path: str) -> tuple[np.ndarray, int]:
    """The WAV's samples as float32 in [-1, 1), and its rate."""
    with wave.open(path, "rb") as w:
        rate, raw = w.getframerate(), w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / np.float32(32768.0), rate


def frame_starts(n: int) -> np.ndarray:
    return np.arange(max(0, 1 + (n - FRAME) // HOP)) * HOP


def power(signal: np.ndarray, rows: np.ndarray | None = None) -> np.ndarray:
    """|rfft(frame * hann)|^2 of every frame (or of frames *rows*), (F, FRAME // 2 + 1) float32."""
    starts = frame_starts(signal.size)
    if rows is not None:
        starts = starts[rows]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(FRAME) / FRAME)
    out = np.empty((starts.size, FRAME // 2 + 1), np.float32)
    for b in range(0, starts.size, BLOCK):
        s = starts[b : b + BLOCK]
        frames = signal[s[:, None] + np.arange(FRAME)[None, :]].astype(np.float64)
        out[b : b + BLOCK] = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2
    return out


def figure(signal: np.ndarray, rate: int, spec: np.ndarray | None = None) -> Figure:
    """The figure's one panel; *spec* the power matrix where the caller has it already."""
    spec = power(signal) if spec is None else spec
    freqs = np.linspace(0.0, rate / 2.0, FRAME // 2 + 1).astype(np.float32)
    times = (np.arange(spec.shape[0]) * HOP + FRAME / 2) / float(rate)
    window = panel.time_window(times)
    cell = {"matrix": spec, "energy": freqs, "y_range": (float(freqs[0]), float(freqs[-1])), "window": window,
            "marks": [], "z_bounds": (None, None), "bounds_range": None, "z_scale": "log"}
    return Figure(None, [[cell]], "linear", COLORMAP, figsize=(10, 3), dpi=DPI, bottom_reserve=0.0,
                  label_lines=1)


def err_ratio(reference: np.ndarray, got: np.ndarray) -> float:
    """The largest |got - reference| over 1e-4 * max(|reference|, 1e-3 * max|reference|) + 1e-2.

    The STFT tolerance of the repository's tests (tests/test_stft.py): a
    cell whose ratio is at most 1 is within it.
    """
    ref = np.asarray(reference, np.float64)
    diff = np.abs(np.asarray(got, np.float64) - ref)
    scale = np.maximum(np.abs(ref), 1e-3 * np.abs(ref).max())
    return float((diff / (1e-4 * scale + 1e-2)).max())
