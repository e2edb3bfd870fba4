"""``chip_smoke.py``'s ``[async]`` harness, rehearsed on the CPU at a small size.

On the card the phase holds the render service's asynchronous path (the
copy stream, pinned staging, the cube cache's eviction, the coalescer) to
the synchronous render, bit for bit.  Here the same harness runs over CPU
tensors, where none of the CUDA machinery exists: it proves the harness --
the reference, the shuffled renders from 8 threads in both modes, the budget
set through ``CST_DEVICE_CUBE_CACHE_BYTES``, the owner swap -- and that it
fails on a wrong cube, not the card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from configurable_spectrograms_torch.render import device_cache  # noqa: E402

torch.set_num_threads(1)

SMALL = {"small": (64, 8, 16), "big": (300, 16, 24), "n_small": 6, "sweep_cells": 1 << 12}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    device_cache.clear_cube_caches()
    yield
    device_cache.clear_cube_caches()


def test_every_round_and_mode_matches_the_synchronous_reference(monkeypatch):
    monkeypatch.setenv("CST_DEVICE_CUBE_CACHE_BYTES", "1")  # the phase sets its own budget and restores this
    out = chip_smoke.run_async(rounds=2, **SMALL)
    assert [(r["round"], r["mode"]) for r in out["runs"]] == [(0, "coalesced"), (0, "inline"),
                                                             (1, "coalesced"), (1, "inline")]
    for r in out["runs"]:
        assert r["differ"] == r["missing"] == 0
        assert r["cube_misses"] > r["distinct_cubes"] and r["cube_hits"] > 0
        assert r["requests"] > chip_smoke.ASYNC_WORKERS
    assert any(s["evicted"] for s in out["swaps"]), "no resident cube was evicted by its owner's death"
    import os

    assert os.environ["CST_DEVICE_CUBE_CACHE_BYTES"] == "1"


def test_panels_mix_what_the_phase_asks_for():
    cubes, panels = chip_smoke.async_panels(**SMALL)
    assert len(cubes) == SMALL["n_small"] + 1 and len({c.shape for c in cubes}) == 2
    assert {p.z_scale for p in panels} == {"log", "linear"}
    assert {p.z_min is None for p in panels} == {True, False}
    assert any(p.window.t_count < p.cube.shape[0] for p in panels)
    assert any(p.pitch_mask.all() for p in panels) and any(not p.pitch_mask.all() for p in panels)
    assert any(p.bounds_energy_range is not None for p in panels)
    assert sum(p.cube is c for p in panels for c in cubes) < len(panels)  # the sweep cases' panels join


def test_a_stale_cube_fails_the_phase(monkeypatch):
    """A resident cube that is not the panel's (what a staging buffer reused too early would leave) is caught."""
    real = device_cache._padded_device_cube
    calls = []

    def stale(cube, Tp, Ap, Ep, device):
        calls.append(1)
        t = real(cube, Tp, Ap, Ep, device)
        return t * 2 if len(calls) == 5 else t

    monkeypatch.setattr(device_cache, "_padded_device_cube", stale)
    with pytest.raises(AssertionError, match="differ from the synchronous reference"):
        chip_smoke.run_async(rounds=1, **SMALL)


def test_swap_owners_keeps_values_and_drops_the_old_owner():
    import weakref

    cubes, panels = chip_smoke.async_panels(**SMALL)
    owners = [weakref.ref(c) for c in cubes]
    values = [c.copy() for c in cubes]
    chip_smoke.swap_owners(cubes, panels, [0, 2])
    assert owners[0]() is None and owners[2]() is None and owners[1]() is cubes[1]
    assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(cubes, values))
    assert sum(p.cube is cubes[0] for p in panels) == len(chip_smoke.async_figure(values[0], 0))
