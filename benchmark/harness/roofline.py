"""The yardstick of the kernel metrics: the card's peaks and the bytes each launch's work needs.

A kernel's roofline share is the least time the card could take for the
work it was given (bytes over the HBM rate: both kernels are bound by
memory) over the time the device trace gives the kernel.  The bytes follow
``chip_smoke.py``'s ``lane_bytes``: each used cube's needed rows (below
its lanes' largest ``t_valid``, at the pitch bins any of its lanes selects)
are read once, and each output byte is written once.
"""

from __future__ import annotations

import numpy as np

#: One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet).
PEAKS = {"hbm_bytes_per_s": 3.35e12, "tf32_flops": 495e12, "bf16_flops": 989e12}

#: Name fragments of each kernel's device functions in the trace.
KERNEL_NAMES = {"collapse": ("cst_collapse_kernel",), "fused_quantize": ("cst_fused_stats_kernel",
                                                                          "cst_fused_map_kernel")}


def read_bytes(cube_shape: tuple, u_idx: np.ndarray, masks: np.ndarray, t_valid: np.ndarray) -> int:
    """Bytes of cube the lanes need: per used cube, E * 4 * its rows * its selected pitch bins."""
    _, T, _, E = cube_shape
    total = 0
    for c in np.unique(u_idx):
        lanes = np.flatnonzero(u_idx == c)
        rows = int(np.clip(t_valid[lanes], 0, T).max())
        total += E * 4 * rows * int(masks[lanes].any(axis=0).sum())
    return total


def collapse_bytes(cube_shape: tuple, u_idx, masks, t_valid) -> int:
    """A collapse launch: the needed rows read, the (L, T, E) float32 sums written."""
    _, T, _, E = cube_shape
    return read_bytes(cube_shape, u_idx, masks, t_valid) + len(u_idx) * T * E * 4


def fused_bytes(cube_shape: tuple, u_idx, masks, t_valid) -> int:
    """A fused launch: the needed rows read; (L, T, E) uint8 indices, (L,) minima, (L, E) flags written."""
    _, T, _, E = cube_shape
    L = len(u_idx)
    return read_bytes(cube_shape, u_idx, masks, t_valid) + L * T * E + L * 4 + L * E


def launch_bytes(kernel: str, cube_shape: tuple, u_idx, masks, t_valid) -> int:
    """The bytes one launch of *kernel* needs, by its rule above."""
    return {"collapse": collapse_bytes, "fused_quantize": fused_bytes}[kernel](cube_shape, u_idx, masks, t_valid)


def share(nbytes: float, device_seconds: float) -> float | None:
    """Per cent of the HBM roofline, or None where the kernel ran no measured time."""
    if nbytes <= 0 or device_seconds <= 0:
        return None
    return 100.0 * nbytes / PEAKS["hbm_bytes_per_s"] / device_seconds


def kernel_seconds(by_op: dict[str, float], kernel: str) -> float:
    return sum(s for name, s in by_op.items() if any(k in name for k in KERNEL_NAMES[kernel]))
