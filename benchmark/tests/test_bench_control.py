"""Each cell's control (the reference one precision below, in the port's place) comes out not correct.

At a size a test run holds; on the card the control runs at each cell's own size
(``python3 benchmark/control.py --workload <cell> --seeds ...``).  The control is
the driver's own ``control()``, judged by the same checks and limits as a run.
"""

from __future__ import annotations

import pytest
from bench_helpers import traffic

import control


def _failed(got: dict) -> set[str]:
    return {name for name, c in got["checks"].items()
            if not (c["value"] <= c["limit"] if c["rule"] == "at_most" else c["value"] >= c["limit"])}


@pytest.mark.parametrize("seed", [3, 2147483659])
def test_fast_control_fails(seed):
    cell = "fast_esa_l2.sample_orbits"
    got = control.control(cell, seed, traffic(cell, n_time={"ees": 300, "ies": 300, "eeb": 320, "ieb": 320},
                                               sample_pngs=6))
    assert got["correct"] is False
    assert "tile_pixels_off_pct" in _failed(got), got
    assert got["checks"]["given_extrema_figures_judged"]["value"] >= 1, got


@pytest.mark.parametrize("seed", [5, 3000000007])
def test_audio_control_fails(seed):
    cell = "audio_wav.clips_5s"
    got = control.control(cell, seed, traffic(cell, seconds=5))
    assert got["correct"] is False
    assert {"stft_err_ratio", "tile_pixels_off_pct"} <= _failed(got), got


def test_control_is_found_by_the_cells_driver_name():
    """control.py names no driver: each workload's driver module exports ``control``."""
    import json

    from bench_helpers import BENCH

    import run

    source = (BENCH / "control.py").read_text()
    for spec_path in sorted((BENCH / "workloads").glob("*.json")):
        driver = json.loads(spec_path.read_text())["driver"]
        assert driver not in source
        assert callable(run.load_module(BENCH / "drivers" / f"{driver}.py").control)
