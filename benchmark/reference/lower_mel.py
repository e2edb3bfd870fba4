"""The mel cell's control: :mod:`reference.lower`'s rule at any frame and hop, the projection in bfloat16 too.

The windowed DFT power from bfloat16 frames and bases (float32
accumulation, rounded to bfloat16), as ``lower.bf16_power`` computes it
at the default frame and hop, then projected on the HTK filterbank in
bfloat16 (float32 accumulation, rounded to bfloat16); the mel centres
rounded to bfloat16.  The configuration states float32, so this is the
reference one precision below it, which the cell's comparison has to
refuse.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import mel


def bf16_mel_power(signal: np.ndarray, rate: int, frame: int, hop: int, n_mels: int) -> np.ndarray:
    """Every frame's mel power, (F, n_mels) float32 holding bfloat16 values."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    n = torch.arange(frame, dtype=torch.float64)[:, None]
    k = torch.arange(frame // 2 + 1, dtype=torch.float64)[None, :]
    ang = 2.0 * torch.pi * n * k / frame
    w = mel.hann(frame)[:, None]
    cos_b = (torch.cos(ang) * w).to(device, torch.bfloat16)
    sin_b = (-torch.sin(ang) * w).to(device, torch.bfloat16)
    weights = mel.filterbank(n_mels, frame, rate).to(device, torch.bfloat16)
    starts = mel.frame_starts(signal.size, frame, hop)
    x = torch.from_numpy(np.ascontiguousarray(signal, np.float32)).to(device)
    offsets = torch.arange(frame, device=device)
    out = np.empty((starts.size, n_mels), np.float32)
    for b in range(0, starts.size, mel.BLOCK):
        s = torch.from_numpy(starts[b : b + mel.BLOCK]).to(device)
        frames = x[s[:, None] + offsets[None, :]].to(torch.bfloat16)
        re = torch.matmul(frames, cos_b).float()
        im = torch.matmul(frames, sin_b).float()
        p = (re * re + im * im).to(torch.bfloat16)
        out[b : b + mel.BLOCK] = torch.matmul(p, weights).float().cpu().numpy()
    return out


def bf16_centres(n_mels: int, rate: int) -> np.ndarray:
    return torch.from_numpy(mel.centres(n_mels, rate)).to(torch.bfloat16).double().numpy()
