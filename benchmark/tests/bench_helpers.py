"""Tiny cells for the harness's CPU tests: the same drivers and reference at a few kilobytes."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

from run import FORBIDDEN  # noqa: E402


def traffic(cell: str, **changes) -> dict:
    spec = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    t = spec["traffic"]
    if spec["driver"] == "fast_archive":
        t.update(orbits=1, n_time={"ees": 48, "ies": 48, "eeb": 52, "ieb": 52}, sample_pngs=4)
    else:
        t.update(seconds=6, rate=8000, recordings=2, rows_share=1.0)
    t.update(changes)
    return t


def run_cell(cell: str, seed: int = 2147483659, seconds: float = 0.05, trace: int = 0, cuda: bool = False,
             lines: list[str] | None = None, **changes) -> tuple[int, dict | None]:
    """run.main at a tiny size, on the CPU (the port's plain kernels) unless *cuda*: (exit code, result or None).

    *lines*, where given, receives the run's standard output, line by line.
    """
    import run

    os.environ["CST_TORCH_DEVICE"] = "cuda" if cuda else "cpu"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                        require_cuda=cuda, traffic=traffic(cell, **changes))
    printed = out.getvalue().strip().splitlines()
    if lines is not None:
        lines.extend(printed)
    try:
        return code, json.loads(printed[-1])
    except (IndexError, json.JSONDecodeError):
        return code, None
