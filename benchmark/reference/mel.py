"""The mel cell's spectrogram worked out again from the WAV's samples, in float64 ``torch`` on the CPU.

The audio CLI with ``--n-mels``, at PANNs' front-end widths (Kong et al.,
"PANNs: Large-Scale Pretrained Audio Neural Networks for Audio Pattern
Recognition", IEEE/ACM TASLP 28, 2020; github.com/qiuqiangkong/audioset_tagging_cnn:
32 kHz, a 1024-sample window, hop 320, 64 mel bins): a periodic Hann
window, the power of the real FFT of each frame, an HTK triangular mel
filterbank written out from its formula, frame-centre times, the mel
centre frequencies on the y axis (linear), and a log colour scale over the
1st-99th percentile, magma, 150 DPI.  Frames are computed in blocks, so a
10-minute recording's 60,000 frames fit.

Departures from PANNs, each the CLI's own (the configuration file lists them):

- the filterbank spans 0 Hz to half the rate (PANNs: 50 Hz to 14 kHz):
  the CLI has no ``fmin``/``fmax``;
- the filterbank is HTK's triangular mel (``2595 log10(1 + f / 700)``,
  each triangle peaking at 1) with no Slaney area normalisation (PANNs
  uses librosa's Slaney mel);
- the input is mono 16-bit PCM WAV (BirdCLEF ships OGG; the CLI reads WAV
  only);
- frames start at sample 0 with no padding (PANNs centres its frames on a
  reflect-padded signal), so 600 s at 32 kHz give 59,997 frames;
- the log is the colour scale's (a log normalisation between the 1st and
  99th percentiles), where PANNs takes ``10 log10`` of the power.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import panel
from reference.judge import Figure

DPI, COLORMAP = 150, "magma"
BLOCK = 8192  # frames per FFT block, to bound the reference's memory


def frame_starts(n: int, frame: int, hop: int) -> np.ndarray:
    """The first sample of every whole frame of an *n*-sample signal."""
    return np.arange(max(0, 1 + (n - frame) // hop)) * hop


def hann(frame: int) -> torch.Tensor:
    """The periodic Hann window, float64."""
    n = torch.arange(frame, dtype=torch.float64)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / frame)


def power(signal, frame: int, hop: int, rows: np.ndarray | None = None) -> torch.Tensor:
    """|rfft(frame * hann)|^2 of every frame (or of frames *rows*): (F, frame // 2 + 1) float64."""
    x = torch.as_tensor(np.asarray(signal), dtype=torch.float64)
    starts = frame_starts(x.numel(), frame, hop)
    if rows is not None:
        starts = starts[rows]
    window, offsets = hann(frame), torch.arange(frame)
    out = torch.empty((starts.size, frame // 2 + 1), dtype=torch.float64)
    for b in range(0, starts.size, BLOCK):
        s = torch.from_numpy(starts[b : b + BLOCK])
        out[b : b + BLOCK] = torch.fft.rfft(x[s[:, None] + offsets[None, :]] * window, dim=-1).abs() ** 2
    return out


def hz_to_mel(f: torch.Tensor) -> torch.Tensor:
    return 2595.0 * torch.log10(1.0 + f / 700.0)


def mel_to_hz(m: torch.Tensor) -> torch.Tensor:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def edges(n_mels: int, rate: int) -> torch.Tensor:
    """The n_mels + 2 triangle corners in Hz: equally spaced in mel from 0 Hz to half the rate."""
    top = hz_to_mel(torch.tensor(rate / 2.0, dtype=torch.float64))
    return mel_to_hz(torch.linspace(0.0, 1.0, n_mels + 2, dtype=torch.float64) * top)


def centres(n_mels: int, rate: int) -> np.ndarray:
    """Each band's centre frequency in Hz (float64): the peaks of the triangles."""
    return edges(n_mels, rate)[1:-1].numpy()


def filterbank(n_mels: int, frame: int, rate: int) -> torch.Tensor:
    """(frame // 2 + 1, n_mels) float64: band m rises linearly from its lower corner to 1 at its centre and
    falls linearly to 0 at its upper corner, over the FFT bins' frequencies k * rate / frame."""
    f = torch.arange(frame // 2 + 1, dtype=torch.float64)[:, None] * (rate / frame)
    hz = edges(n_mels, rate)
    lo, ctr, hi = hz[None, :-2], hz[None, 1:-1], hz[None, 2:]
    return torch.clamp(torch.minimum((f - lo) / (ctr - lo), (hi - f) / (hi - ctr)), min=0.0)


def mel_power(signal: np.ndarray, rate: int, frame: int, hop: int, n_mels: int,
              rows: np.ndarray | None = None) -> np.ndarray:
    """The power of every frame (or of frames *rows*) projected on the filterbank: (F, n_mels) float64."""
    weights = filterbank(n_mels, frame, rate)
    x = torch.as_tensor(np.asarray(signal), dtype=torch.float64)
    rows = np.arange(frame_starts(x.numel(), frame, hop).size) if rows is None else np.asarray(rows)
    out = np.empty((rows.size, n_mels), np.float64)
    for b in range(0, rows.size, BLOCK):
        out[b : b + BLOCK] = (power(x, frame, hop, rows[b : b + BLOCK]) @ weights).numpy()
    return out


def figure(signal: np.ndarray, rate: int, frame: int, hop: int, n_mels: int,
           spec: np.ndarray | None = None) -> Figure:
    """The figure's one panel: the mel power (float64, drawn from float32) over frame-centre times, its rows
    at the mel centres; *spec* the (F, n_mels) mel power where the caller has it already."""
    spec = mel_power(signal, rate, frame, hop, n_mels) if spec is None else spec
    y = centres(n_mels, rate).astype(np.float32)
    times = (np.arange(spec.shape[0]) * hop + frame / 2) / float(rate)
    cell = {"matrix": np.asarray(spec, np.float32), "energy": y, "y_range": (float(y[0]), float(y[-1])),
            "window": panel.time_window(times), "marks": [], "z_bounds": (None, None), "bounds_range": None,
            "z_scale": "log"}
    return Figure(None, [[cell]], "linear", COLORMAP, figsize=(10, 3), dpi=DPI, bottom_reserve=0.0,
                  label_lines=1)


def centres_rel_err(reference: np.ndarray, got: np.ndarray) -> float:
    """The largest |got - reference| / reference over the bands (inf where the band counts differ)."""
    ref, got = np.asarray(reference, np.float64), np.asarray(got, np.float64)
    if ref.shape != got.shape:
        return float("inf")
    return float((np.abs(got - ref) / ref).max())
