"""The kernel metrics' byte rule is chip_smoke.py's lane_bytes rule."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from bench_helpers import ROOT

from harness import roofline


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_for_bytes", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", range(6))
def test_read_bytes_match_lane_bytes(chip_smoke, seed):
    from configurable_spectrograms_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    U, T, A, E, L = int(rng.integers(1, 4)), int(rng.integers(8, 64)), 16, int(rng.integers(4, 40)), int(rng.integers(1, 12))
    cubes = torch.zeros((U, T, A, E))
    u_idx = torch.from_numpy(rng.integers(0, U, L).astype(np.int32))
    masks = torch.from_numpy(rng.random((L, A)) < 0.4)
    t_valid = torch.from_numpy(rng.integers(0, T + 1, L).astype(np.int32))
    need, _, _ = chip_smoke.lane_bytes(K, cubes, u_idx, masks, t_valid)
    got = roofline.read_bytes(tuple(cubes.shape), u_idx.numpy(), masks.numpy(), t_valid.numpy())
    assert got == need
    assert roofline.collapse_bytes(tuple(cubes.shape), u_idx.numpy(), masks.numpy(), t_valid.numpy()) == need + L * T * E * 4
    assert roofline.fused_bytes(tuple(cubes.shape), u_idx.numpy(), masks.numpy(), t_valid.numpy()) == \
        need + L * T * E + L * 4 + L * E


def test_share_against_the_hbm_peak():
    assert roofline.share(3.35e12, 1.0) == pytest.approx(100.0)
    assert roofline.share(0, 1.0) is None and roofline.share(1.0, 0.0) is None
    by_op = {"cst_collapse_kernel(float const*)": 0.5, "cst_fused_stats_kernel(x)": 0.25, "cst_fused_map_kernel(y)": 0.25}
    assert roofline.kernel_seconds(by_op, "collapse") == 0.5 and roofline.kernel_seconds(by_op, "fused_quantize") == 0.5


def test_reader_counts_the_kept_launches_after_the_window():
    """The traced window keeps each launch's shape and lane tensors; the reader counts their bytes afterwards."""
    from harness.readers import kernel_roofline

    shape = (2, 10, 8, 6)
    lanes = (torch.tensor([0, 1, 1], dtype=torch.int32), torch.ones((3, 8), dtype=torch.bool),
             torch.tensor([10, 4, 7], dtype=torch.int32))
    want = roofline.fused_bytes(shape, *(t.numpy() for t in lanes))
    record = {"outcome": {"launch_lanes": {"fused_quantize": [(shape, *lanes), (shape, *lanes)]}},
              "device": {"by_op": {"cst_fused_map_kernel": 2 * want / roofline.PEAKS["hbm_bytes_per_s"]}}}
    assert kernel_roofline(record, "fused_quantize") == pytest.approx(100.0)
    assert kernel_roofline(record, "collapse") is None
