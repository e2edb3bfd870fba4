"""The benchmark of configurable_spectrograms_torch: one cell, one seed, one window, one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  Everything about a cell lives in files found by name:
``BENCHMARK.json`` lists the cells and metrics; ``workloads/<cell>.json``
holds the cell's configuration name, traffic parameters and driver;
``configs/<config>.json`` the deployment; ``drivers/<driver>.py`` makes
the inputs from the seed, warms up, runs the window and checks what it
produced against ``reference/``; ``metrics/<metric>.py`` reads one
per-layer metric from the traced run's spans, counters and device trace.
This file knows no cell.

Set-up (imports, making the inputs, building and warming up the port) is
``setup_s``; its parts print on lines of their own.  The window runs with
the profiler off (``--trace 0``, the end-to-end metrics) or on (``--trace
1``, the per-layer metrics).  Then the driver compares the window's output
with the reference, each number beside its limit, on standard error and
under ``checks`` at the end of the result, the last line of standard
output.  The run fails, with no result line, without the card(s), or if
``jax``, ``jaxlib``, ``flax`` or the JAX package was imported.
"""

from __future__ import annotations

import resource
import time

T0 = time.perf_counter()
RSS0_KIB = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # first thing: the start's peak

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "configurable_spectrograms_tpu")
EXIT_NO_DEVICE, EXIT_FORBIDDEN_IMPORT = 3, 4


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's data-driven folders, by file path (names may hold dots)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"cstbench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def cell_metrics(entries: list[dict], cell: str) -> list[dict]:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def environment() -> None:
    """Every build and kernel cache of the port at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["CST_NATIVE_CACHE_DIR"] = str(build / "cst_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("CST_TORCH_DEVICE", "cuda")


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them (None where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def say(*parts) -> None:
    print(*parts, flush=True)


def main(argv: list[str] | None = None, require_cuda: bool = True, traffic: dict | None = None) -> int:
    """Run one cell; *require_cuda* and *traffic* (replacing the cell's mix) are for the CPU tests only."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {args.workload!r}")
    spec = load_json(HERE / "workloads" / f"{args.workload}.json")
    if traffic is not None:
        spec["traffic"] = traffic
    if not (HERE / "configs" / f"{entry['config']}.json").is_file():
        raise SystemExit(f"no configuration file for {entry['config']!r}")
    environment()
    for path in (str(HERE), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(1, path)
    scratch = tempfile.mkdtemp(prefix="cst_bench_")
    try:
        return run(args, bench, entry, spec, scratch, require_cuda)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def run(args, bench: dict, entry: dict, spec: dict, scratch: str, require_cuda: bool) -> int:
    from harness.trace import DeviceTrace, Recorder

    parts: dict[str, float] = {}
    t = time.perf_counter()
    import torch

    parts["import_torch_s"] = time.perf_counter() - t
    cuda = torch.cuda.is_available() and torch.cuda.device_count() >= int(entry["chips"])
    if require_cuda and not cuda:
        print(f"no result: the cell needs {entry['chips']} CUDA device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return EXIT_NO_DEVICE

    rec = Recorder()
    ctx = SimpleNamespace(seed=args.seed, trace=bool(args.trace), traffic=spec["traffic"], scratch=scratch,
                          root=ROOT, recorder=rec, cuda=cuda, log=say)
    driver = load_module(HERE / "drivers" / f"{spec['driver']}.py").Driver(ctx)
    parts.update(driver.setup())
    setup_s = time.perf_counter() - T0
    for name, seconds in parts.items():
        say(f"[setup] {name}={seconds:.3f}")
    say(f"[setup] setup_s={setup_s:.3f}")

    trace = DeviceTrace(scratch) if args.trace else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if trace:
        trace.start()
    outcome = driver.window(args.seconds)
    if trace:
        trace.stop()
    memory_peak = torch.cuda.max_memory_reserved() if cuda else 0
    rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    say(f"[window] {json.dumps(outcome['log'])}")

    values: dict[str, float] = {"setup_s": setup_s, **outcome["e2e"]}
    if rss_kib > RSS0_KIB:
        values["peak_rss_gib"] = rss_kib * 1024 / 2**30
    else:
        print(f"peak_rss_gib not readable: ru_maxrss {rss_kib} KiB at the end, {RSS0_KIB} at the start",
              file=sys.stderr)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": int(entry["chips"]),
              "memory_peak_bytes": int(memory_peak)}
    limit = power_limit() if cuda else None
    if limit:
        device["name_and_power_limit"] = limit
    result = {"correct": False, "attempted": outcome["attempted"], "failed": outcome["failed"]}
    breakdown = None
    if trace:
        summary = trace.summary(rec, outcome.get("timer"))
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        record = {"recorder": rec, "outcome": outcome, "device": summary}
        metrics = {}
        for m in cell_metrics(bench["per_layer"], args.workload):
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench["end_to_end"], args.workload) if m["name"] in values}
        for name, m in metrics.items():
            say(f"[metric] {name}={m['value']} {m['unit']}")

    driver.release()
    checks = driver.check()
    found = forbidden_modules()
    if found:
        print(f"no result: the run imported {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN_IMPORT
    result["correct"] = all(c["ok"] for c in checks) and outcome["failed"] == 0
    result.update(metrics=metrics, device=device)
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"], "rule": c["rule"]} for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']} ({c['rule']} {c['limit']}){'' if c['ok'] else ' FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # the port's worker threads and pools are done; nothing may print after the result
