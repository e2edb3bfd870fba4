"""Per-file statistics for the folder-wide extrema pass (port of ``ops/extrema_ops.py``).

Each file reduces to two fixed-size summaries: per-energy-bin
positive-finite counts (E,) of the pitch-collapsed matrix, and a
4096-bin log10 histogram of its positive-finite values (24 decades, upper
bin edges answer percentiles within 1.4%% relative).  On the device, a
batch of files is one launch of the collapse kernel followed by a
``torch.bincount`` (the JAX module's sort-based ``sorted_bincount`` was a
TPU compile workaround).  The numpy half -- :func:`collapsed_positives`,
:func:`value_bins`, :func:`host_file_stats`, :func:`hist_percentile` -- is
copied from the JAX module unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from configurable_spectrograms_torch.ops.kernels import collapse_lanes

HIST_BINS = 4096
LOG_LO = -12.0
LOG_HI = 12.0

#: The device of the last device-backend :func:`batched_file_stats` launch
#: (``str(device)``); ``None`` before one.
LAST_DISPATCH: dict[str, str | None] = {"device": None}


def file_extrema_stats_lanes(cubes: torch.Tensor, t_valid: torch.Tensor) -> dict[str, torch.Tensor]:
    """Extrema summaries of L (T, A, E) cubes, stacked as (L, T, A, E).

    All pitch bins count (NaN padding adds nothing).  Returns ``counts``
    (L, E) int32 and ``hist`` (L, HIST_BINS) int32.
    """
    L, T, A, E = cubes.shape
    dev = cubes.device
    collapsed = collapse_lanes(
        cubes,
        torch.arange(L, dtype=torch.int32, device=dev),
        torch.ones((L, A), dtype=torch.bool, device=dev),
        t_valid.to(device=dev, dtype=torch.int32),
    )
    fp = torch.isfinite(collapsed) & (collapsed > 0)
    counts = fp.sum(dim=1).to(torch.int32)
    logv = torch.log10(torch.where(fp, collapsed, torch.ones((), dtype=torch.float32, device=dev)))
    # A device-tensor divisor keeps the IEEE quotient on CUDA (a Python
    # scalar divisor would become a reciprocal multiply there).
    span = torch.tensor(LOG_HI - LOG_LO, dtype=torch.float32, device=dev)
    bin_f = (logv - LOG_LO) / span * HIST_BINS
    bins = torch.clamp(bin_f.to(torch.int32), 0, HIST_BINS - 1)
    # Invalid cells go to an overflow slot; one bincount serves every lane.
    flat = torch.where(fp, bins, HIST_BINS).reshape(L, -1).to(torch.int64)
    flat = flat + torch.arange(L, device=dev).view(L, 1) * (HIST_BINS + 1)
    hist = torch.bincount(flat.reshape(-1), minlength=L * (HIST_BINS + 1))
    return {"counts": counts, "hist": hist.view(L, HIST_BINS + 1)[:, :HIST_BINS].to(torch.int32)}


def file_extrema_stats(cube: torch.Tensor, t_valid: int) -> dict[str, torch.Tensor]:
    """Extrema summaries of one (T, A, E) cube: ``counts`` (E,), ``hist`` (HIST_BINS,)."""
    out = file_extrema_stats_lanes(cube.float().unsqueeze(0).contiguous(), torch.tensor([int(t_valid)]))
    return {"counts": out["counts"][0], "hist": out["hist"][0]}


def collapsed_positives(cube: np.ndarray) -> np.ndarray:
    """The reference's pooled samples for one file: positive finite values
    of the pitch-collapsed (nansum over axis 1) float32 matrix
    (reference fast/extrema.py:260-267).  The single host-side definition
    of this math -- the exact-percentile tracker and the extrema pass both
    use it, so their pools can never drift apart.
    """
    collapsed = np.where(np.isnan(cube), np.float32(0.0), cube).sum(axis=1, dtype=np.float32)
    return collapsed[np.isfinite(collapsed) & (collapsed > 0)]


def value_bins(values: np.ndarray) -> np.ndarray:
    """The log10 histogram bin of each positive finite float32 value.

    The single host-side definition of the binning (identical float32
    arithmetic to :func:`file_extrema_stats` on device); the
    exact-percentile tracker's rank/gather consistency depends on every
    consumer binning identically.
    """
    logv = np.log10(values, dtype=np.float32)
    return np.clip(
        ((logv - np.float32(LOG_LO)) / np.float32(LOG_HI - LOG_LO) * np.float32(HIST_BINS)).astype(np.int32),
        0,
        HIST_BINS - 1,
    )


def host_file_stats(cube: np.ndarray) -> dict[str, np.ndarray]:
    """Pure-numpy mirror of :func:`file_extrema_stats` (same float32 math)."""
    collapsed = np.where(np.isnan(cube), np.float32(0.0), cube).sum(axis=1, dtype=np.float32)
    fp = np.isfinite(collapsed) & (collapsed > 0)
    counts = fp.sum(axis=0).astype(np.int32)
    hist = np.bincount(value_bins(collapsed[fp]), minlength=HIST_BINS).astype(np.int32)
    return {"counts": counts, "hist": hist}


def batched_file_stats(cubes: list[np.ndarray]) -> list[dict[str, np.ndarray]]:
    """:func:`file_extrema_stats` for many host cubes: one collapse launch.

    Cubes pad to the batch's largest (T, A, E) with NaN, which the
    collapse ignores.  With ``CST_RENDER_BACKEND=host`` the stats compute
    in numpy instead.
    """
    if not cubes:
        return []
    from configurable_spectrograms_torch.render.backend import render_backend

    if render_backend() == "host":
        return [host_file_stats(np.asarray(c, np.float32)) for c in cubes]
    from configurable_spectrograms_torch.render.device_cache import stack_cubes
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    device = get_device()
    Tm = max(c.shape[0] for c in cubes)
    Am = max(c.shape[1] for c in cubes)
    Em = max(c.shape[2] for c in cubes)
    batch = stack_cubes(cubes, Tm, Am, Em, device, cached=False)  # each file is read once
    t_valid = torch.tensor([c.shape[0] for c in cubes], dtype=torch.int32, device=device)
    out = file_extrema_stats_lanes(batch, t_valid)
    LAST_DISPATCH["device"] = str(device)
    counts = out["counts"].cpu().numpy()
    hist = out["hist"].cpu().numpy()
    return [{"counts": counts[i, : c.shape[2]], "hist": hist[i]} for i, c in enumerate(cubes)]


def hist_percentile(hist: np.ndarray, q: float) -> float:
    """Percentile of the values summarized by a log10 *hist* (upper-edge rule).

    Linear-interpolation position like ``np.nanpercentile`` on the sample
    count, resolved to the containing bin's upper edge in value space.
    Returns 0.0 for an empty histogram.
    """
    n = int(hist.sum())
    if n == 0:
        return 0.0
    pos = q / 100.0 * (n - 1)
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, pos + 1.0, side="left"))
    b = min(b, HIST_BINS - 1)
    edge = LOG_LO + (b + 1) / HIST_BINS * (LOG_HI - LOG_LO)
    return float(10.0**edge)
