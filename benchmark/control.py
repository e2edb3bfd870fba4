"""The control of each cell's comparison: the reference one precision below, judged as the port's output is.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

The configurations state float32 (the cubes, the spectrogram power).  A
cell's driver (``drivers/<driver>.py``, named by ``workloads/<cell>.json``)
exports ``control(seed, traffic, root)``: it puts :mod:`reference.lower`
in the port's place, at the cell's own size, and returns the same checks,
with the same limits, as the driver's ``check()`` makes of a run.  This
prints each compared number beside its limit, one line per seed, with
``correct`` as a run would have it: a control has to come out not
correct.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for path in (str(HERE), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

from run import load_json, load_module  # noqa: E402


def control(workload: str, seed: int, traffic: dict | None = None) -> dict:
    """{"correct", "checks"} of the cell's control on *seed* (*traffic* replaces the cell's mix)."""
    spec = load_json(HERE / "workloads" / f"{workload}.json")
    driver = load_module(HERE / "drivers" / f"{spec['driver']}.py")
    checks = driver.control(seed, traffic or spec["traffic"], ROOT)
    return {"correct": all(c["ok"] for c in checks),
            "checks": {c["name"]: {"value": c["value"], "limit": c["limit"], "rule": c["rule"]} for c in checks}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    args = parser.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed, **control(args.workload, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
