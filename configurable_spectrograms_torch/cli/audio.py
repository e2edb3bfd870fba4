"""Render an audio STFT/mel spectrogram from a WAV file (port of ``single_plot_audio_spectrogram.py``).

    python -m configurable_spectrograms_torch.cli.audio --wav-file in.wav --output out.png \
        [--frame-length 1024] [--hop-length 256] [--n-mels 128] [--stft-method fft|matmul|pallas]

Reads a WAV file (stdlib ``wave``; 8/16/32-bit PCM, mixed to mono; a 16-bit
mono file goes to the device as int16 and is widened there), computes the
windowed STFT (and optional mel projection) on the device -- or in numpy
with ``CST_RENDER_BACKEND=host`` -- and renders it through
``generic_plot_spectrogram_set`` exactly like CDF data.  Exit codes: 0
saved, 1 nothing to plot, 130 interrupted.
"""

from __future__ import annotations

import argparse
import os
import wave
from pathlib import Path

import numpy as np
import torch

from configurable_spectrograms_torch.cli.common import report_render_outcome, run_cli
from configurable_spectrograms_torch.ops.stft import METHODS, audio_spectrogram_dataset
from configurable_spectrograms_torch.render.backend import render_backend
from configurable_spectrograms_torch.render.plotting import close_all_axes_and_clear, generic_plot_spectrogram_set
from configurable_spectrograms_torch.utils.timing import active_stage


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Load a mono-mixed float32 signal + sample rate from a WAV file."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        sig = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        sig = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        sig = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        sig = sig.reshape(-1, channels).mean(axis=1)
    return sig, rate


def load_pcm16_on_device(path: str) -> tuple[torch.Tensor, int] | None:
    """A 16-bit mono WAV's samples as a float32 tensor on the port's device, or None for any other WAV.

    The data chunk's int16 samples are read straight into a host tensor --
    pinned on a card, from torch's caching host allocator -- copied to the
    device without blocking, on the current stream (the one the STFT then
    runs on), and widened there.  Widening int16 and scaling by 2**-15 are
    both exact, so the tensor holds :func:`load_wav`'s array bit for bit.
    The caching host allocator records an event on each copy out of a
    pinned block and hands the block out again only once that copy has
    finished, so the next file's read cannot overwrite samples still in
    flight.  A data chunk shorter than its header says gives the samples
    that were read, as ``readframes`` does.
    """
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    with open(path, "rb") as f, wave.open(f) as w:
        # wave.open leaves f at the first byte of the data chunk.
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            return None
        rate = w.getframerate()
        # The buffer is sized by what the file holds, not by what its header promises.
        n = min(w.getnframes(), (os.fstat(f.fileno()).st_size - f.tell()) // 2)
        device = get_device()
        pinned = device.type == "cuda"
        host = torch.empty(n, dtype=torch.int16, pin_memory=pinned)
        got = f.readinto(host.numpy().view(np.uint8)) // 2
    with active_stage("pcm_upload"):
        signal = host[:got].to(device, non_blocking=pinned).to(torch.float32).mul_(2.0 ** -15)
    return signal, rate


def render_audio_spectrogram(
    wav_path: str,
    output_path: str,
    frame_length: int = 1024,
    hop_length: int = 256,
    n_mels: int | None = None,
    y_scale: str = "linear",
    z_scale: str = "log",
    colormap: str = "magma",
    stft_method: str = "fft",
) -> bool:
    """WAV -> one spectrogram PNG at 150 DPI; returns whether a figure was written."""
    with active_stage("wav_load"):
        pcm = load_pcm16_on_device(wav_path) if render_backend() == "device" else None
        signal, rate = pcm if pcm is not None else load_wav(wav_path)
    dataset = audio_spectrogram_dataset(
        signal, rate, frame_length=frame_length, hop_length=hop_length, n_mels=n_mels,
        label=Path(wav_path).stem, method=stft_method,
    )
    fig, _ = generic_plot_spectrogram_set(
        [dataset],
        x_is_unix=False,
        y_scale=y_scale,
        z_scale=z_scale,
        colormap=colormap,
        y_min=float(dataset["y"][0]),
        y_max=float(dataset["y"][-1]),
        show=False,
    )
    if fig is None:
        return False
    fig.savefig(output_path, dpi=150)
    # The figure and its axes refer to each other; clearing them frees the
    # spectrogram now rather than at the cyclic collector's next full pass.
    close_all_axes_and_clear(fig)
    return True


def main() -> int:
    parser = argparse.ArgumentParser(description="Render an audio STFT/mel spectrogram from a WAV file.")
    parser.add_argument("--wav-file", required=True, help="Input WAV file (PCM).")
    parser.add_argument("--output", required=True, help="Destination PNG file path.")
    parser.add_argument("--frame-length", type=int, default=1024)
    parser.add_argument("--hop-length", type=int, default=256)
    parser.add_argument("--n-mels", type=int, default=None, help="Mel bands (omit for raw STFT bins).")
    parser.add_argument("--y-scale", choices=("linear", "log"), default="linear")
    parser.add_argument("--z-scale", choices=("linear", "log"), default="log")
    parser.add_argument("--colormap", default="magma")
    parser.add_argument(
        "--stft-method", choices=METHODS, default="fft",
        help="Device STFT program: torch rFFT, DFT-basis matmuls, or the hand-written CUDA "
             "windowed-DFT power kernel (named 'pallas' after the JAX package's kernel).",
    )
    args = parser.parse_args()

    produced = render_audio_spectrogram(
        args.wav_file,
        args.output,
        frame_length=args.frame_length,
        hop_length=args.hop_length,
        n_mels=args.n_mels,
        y_scale=args.y_scale,
        z_scale=args.z_scale,
        colormap=args.colormap,
        stft_method=args.stft_method,
    )
    return report_render_outcome(produced, args.output)


if __name__ == "__main__":
    run_cli(main)
