"""On the card: each cell's driver at a tiny size, traced, reads every per-layer metric it lists.

Run on the chip with ``python -m pytest benchmark/tests/test_bench_card.py -m cuda``; skips on the CPU.
"""

from __future__ import annotations

import json

import pytest
from bench_helpers import ROOT, run_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fast_esa_l2.sample_orbits", "audio_wav.clips_5s"])
def test_tiny_traced_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code, result = run_cell(cell, trace=1, cuda=True, seconds=0.5)
    assert code == 0 and result is not None and result["correct"], result
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
    assert set(result["metrics"]) == listed
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name, m in result["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100, (name, m)
