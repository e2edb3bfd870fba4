"""The reference one precision below the configurations' float32: the controls' stand-in for the port.

Each cell's control puts these in the port's place and judges what they
produce as a run judges the port's output.  The pitch-angle sums and the
spectrogram power are computed from bfloat16 values, accumulated in
float32 and rounded to bfloat16; the rest (extrema, bounds, quantisation,
the tiles' pixels) is the reference's own.
"""

from __future__ import annotations

import numpy as np

from reference import judge, layout, panel
from reference.colormaps import lut


def painted(fig: judge.Figure, text: layout.Text) -> np.ndarray:
    """An RGB image of *fig*'s tiles alone, at the places a PNG of it has them (white elsewhere)."""
    nrows, ncols = len(fig.rows), len(fig.rows[0])
    title = (fig.title, fig.title_pt) if fig.title else None
    rects = layout.tile_rects(text, fig.figsize, fig.dpi, nrows, ncols, title, fig.bottom_reserve, fig.label_lines)
    img = np.full((round(fig.figsize[1] * fig.dpi), round(fig.figsize[0] * fig.dpi), 3), 255, np.uint8)
    colors = np.concatenate([lut(fig.colormap)[:, :3], [[255, 255, 255]]]).astype(np.uint8)
    for (r, c), (x0, y0, x1, y1) in rects.items():
        img[y0:y1, x0:x1] = colors[panel.tile(fig.quantized(r, c), y1 - y0, x1 - x0, fig.y_scale)]
    return img


def bf16_collapse(cube: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The pitch-angle sum from bfloat16 values, accumulated in float32, rounded to bfloat16."""
    import torch

    clean = torch.from_numpy(np.where(np.isnan(cube), np.float32(0.0), cube)).to(torch.bfloat16)
    sums = clean[:, torch.from_numpy(mask), :].sum(dim=1, dtype=torch.float32)
    return sums.to(torch.bfloat16).float().numpy()


def bf16_power(signal: np.ndarray, rows: np.ndarray | None = None) -> np.ndarray:
    """The Hann-windowed DFT power as a bfloat16 matrix product (float32 accumulation), rounded to bfloat16."""
    import torch

    from reference import audio as ref_audio

    device = "cuda" if torch.cuda.is_available() else "cpu"
    n = np.arange(ref_audio.FRAME, dtype=np.float64)[:, None]
    k = np.arange(ref_audio.FRAME // 2 + 1, dtype=np.float64)[None, :]
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(ref_audio.FRAME) / ref_audio.FRAME))[:, None]
    ang = 2.0 * np.pi * n * k / ref_audio.FRAME
    cos_b = torch.tensor(np.cos(ang) * w, dtype=torch.bfloat16, device=device)
    sin_b = torch.tensor(-np.sin(ang) * w, dtype=torch.bfloat16, device=device)
    starts = ref_audio.frame_starts(signal.size)
    if rows is not None:
        starts = starts[rows]
    x = torch.from_numpy(signal).to(device)
    out = np.empty((starts.size, ref_audio.FRAME // 2 + 1), np.float32)
    for b in range(0, starts.size, ref_audio.BLOCK):
        idx = torch.from_numpy(starts[b : b + ref_audio.BLOCK, None] + np.arange(ref_audio.FRAME)[None, :]).to(device)
        frames = x[idx].to(torch.bfloat16)
        re = torch.matmul(frames, cos_b).float()
        im = torch.matmul(frames, sin_b).float()
        out[b : b + ref_audio.BLOCK] = (re * re + im * im).to(torch.bfloat16).float().cpu().numpy()
    return out
