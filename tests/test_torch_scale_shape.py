"""``chip_smoke.py``'s ``[scale]`` at a cube shape of its own, on the CPU.

The CPU rehearsal of ``python3 chip_smoke.py --scale-orbits 12 --scale-shape 8192x64x128``:

* the whole phase (``run_scale(..., shape=...)``) at a tiny shape that is
  not the default one: the archive is made at that shape, and the
  installed copy's flagship CLI over its three faults is killed, resumed
  and held to the host backend under the default shape's rules;
* the free disk the phase asks for and each run's time limit grow with
  the shape's bytes; too little disk fails the phase before the archive
  is made, and a run past its limit fails it;
* the runner's counters (``chip_smoke.FLAGSHIP_RUNNER``): one decode per
  dataset-cache miss, and the device cube cache's evictions by budget and
  by owner death, with ``CST_DATASET_CACHE_BYTES`` below one orbit's
  cubes (two orbits thrash the dataset cache) and with
  ``CST_DEVICE_CUBE_CACHE_BYTES`` below one orbit's padded cubes;
* the runner's peak RSS is the child's own, not the spawning parent's;
* the default run's ``[phases]`` line: each phase's seconds less those of
  the phases it ran (``chip_smoke.timed``).
"""

import collections
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SHAPE = (48, 8, 12)  # not chip_smoke.SCALE_SHAPE
REAL = (8192, 64, 128)  # the instrument's cube
ORBITS = [5000, 5001]
#: One dataset-cache entry of a SHAPE file: the cube, its times (float64), energies and pitch angles (float32).
ENTRY_BYTES = chip_smoke.cube_bytes(SHAPE) + 8 * SHAPE[0] + 4 * SHAPE[2] + 4 * SHAPE[1]
PADDED_CUBE_BYTES = 4 * 256 * 8 * 16  # SHAPE as the dispatch pads it (render/panel.py:_bucket)


@pytest.fixture
def no_card(monkeypatch):
    """nvidia-smi's readings, which the phase samples, as they read where no card is."""
    monkeypatch.setattr(chip_smoke, "compute_apps", lambda: [])
    monkeypatch.setattr(chip_smoke, "gpu_memory_used_mib", lambda: 0)


def test_run_scale_at_a_shape_of_its_own(no_card, tmp_path, capsys):
    """The phase at 48x8x12: its archive at that shape, every rule of the default shape held, the new counts made."""
    assert SHAPE != chip_smoke.SCALE_SHAPE
    got = chip_smoke.run_scale({}, 10, str(tmp_path), device="cpu", shape=SHAPE)
    out = capsys.readouterr().out
    archive = next(line for line in out.splitlines() if line.startswith("[scale] step=archive"))
    assert " shape=48x8x12 " in archive and f" cube_bytes={40 * chip_smoke.cube_bytes(SHAPE)} " in archive
    assert " host_mem_total_kib=" in archive
    assert got["shape"] == "48x8x12" and got["pngs"] >= got["floor"] == 7 * 40
    # Every file is decoded by run 1's pre-pass, and run 2 decodes what it renders again (its cache starts cold).
    assert got["decodes_per_file_runs_1_2"] > 1
    # The pre-pass ships every good cube once and the render again: more than one upload per cube.
    assert got["uploads_per_cube_runs_1_2"] > 1
    assert got["budget_evictions_runs_1_2"] == 0  # a quarter of the host's memory holds this archive
    for run in (1, 2):
        line = next(line for line in out.splitlines() if line.startswith(f"[scale] run={run} "))
        fields = dict(f.split("=", 1) for f in line.split()[1:])
        assert int(fields["decodes"]) == int(fields["dataset_misses"]) > 0
        assert float(fields["host_peak_rss_mib"]) > 0 and float(fields["figures_per_s"]) > 0
        assert int(fields["upload_bytes"]) % chip_smoke.cube_bytes(SHAPE) == 0  # whole cubes, never the padding


def test_disk_need_and_time_limits_follow_the_shape():
    """Both grow with the cube's bytes, and the real cube's archive of 12 orbits asks for its 48 cubes' bytes."""
    small, n = chip_smoke.SCALE_SHAPE, 12
    assert chip_smoke.cube_bytes(REAL) == 268_435_456
    grow = chip_smoke.cube_bytes(REAL) - chip_smoke.cube_bytes(small)
    assert chip_smoke.scale_disk_need(n, REAL) - chip_smoke.scale_disk_need(n, small) == 4 * n * grow
    assert chip_smoke.scale_disk_need(n, REAL) > 4 * n * chip_smoke.cube_bytes(REAL)  # and the PNGs
    assert chip_smoke.scale_disk_need(2 * n, REAL) > 2 * chip_smoke.scale_disk_need(n, REAL) - 1e9
    per_gb = chip_smoke.SCALE_LIMIT_S_PER_GB
    assert chip_smoke.scale_limit_s(n, REAL) - chip_smoke.scale_limit_s(n, small) == pytest.approx(
        n * per_gb * 4 * grow / 1e9)
    assert chip_smoke.scale_limit_s(n / 2, REAL) < chip_smoke.scale_limit_s(n, REAL)
    assert chip_smoke.parse_shape("8192x64x128") == REAL
    for bad in ("8192x64", "0x8x8", "axbxc"):
        with pytest.raises(Exception, match="TxAxE"):
            chip_smoke.parse_shape(bad)


def test_too_little_disk_fails_before_the_archive_is_made(monkeypatch, tmp_path):
    need = chip_smoke.scale_disk_need(10, REAL)
    usage = collections.namedtuple("usage", "total used free")
    monkeypatch.setattr(shutil, "disk_usage", lambda path: usage(need, 0, need - 1))
    with pytest.raises(AssertionError, match=r"\[scale\] needs"):
        chip_smoke.run_scale({}, 10, str(tmp_path), device="cpu", shape=REAL)
    assert list(tmp_path.iterdir()) == []


def test_a_run_past_its_limit_fails(no_card, tmp_path):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    env = dict(os.environ, CST_TORCH_DEVICE="cpu", PYTHONPATH=str(REPO))
    with pytest.raises(AssertionError, match=r"run late still running after 0 s"):
        chip_smoke.flagship_process(str(cwd), env, "late", str(tmp_path / "late.json"), timeout=0)


def _peak_rss_mib() -> float:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) for line in f if line.startswith("VmHWM:")) / 1024


def test_runner_reports_its_own_peak_rss_not_its_parents(tmp_path):
    """``ru_maxrss`` of a spawned child starts at its parent's peak; the runner reports the child's own (VmHWM).

    Here the parent holds 1 GiB more than the child ever does, so a report
    of the parent's peak shows.
    """
    import numpy as np

    ballast = np.ones(1 << 27)  # 1 GiB, every page touched
    env = {k: v for k, v in os.environ.items() if not k.startswith("CST_")}
    env.update(CST_TORCH_DEVICE="cpu", PYTHONPATH=str(REPO))
    report = tmp_path / "report.json"
    proc = subprocess.run([sys.executable, "-c", chip_smoke.FLAGSHIP_RUNNER, str(report)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    parent = _peak_rss_mib()
    assert ballast.nbytes >> 20 == 1024 and parent > 1024
    child = json.loads(report.read_text())["host_peak_rss_mib"]
    assert 0 < child < parent - 512, (child, parent)


def _archive(root: Path) -> Path:
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    cwd = root / "cwd"
    cwd.mkdir(parents=True)
    synth_fast_archive(str(cwd / "FAST_data"), ORBITS, cusp_csv_path=str(cwd / "FAST_Cusp_Indices.csv"), seed=5,
                       n_time=SHAPE[0], n_angle=SHAPE[1], n_energy=SHAPE[2])
    return cwd


#: (case, environment, what the report must show; *files* is the archive's file count).
COUNTER_CASES = [
    ("default", {},
     lambda r, files: r["decodes"] == files and r["budget_evictions"] == r["owner_evictions"] == 0),
    # 2.5 datasets: an orbit's four files cycle through the FIFO, every load misses, every dead cube leaves.
    ("dataset_thrash", {"CST_DATASET_CACHE_BYTES": str(int(2.5 * ENTRY_BYTES))},
     lambda r, files: r["decodes"] > 2 * files and r["budget_evictions"] == 0 and r["owner_evictions"] > 0),
    # 2.5 padded cubes on the device: the budget evicts, the owners (the cached datasets) all live.
    ("device_budget", {"CST_DEVICE_CUBE_CACHE_BYTES": str(int(2.5 * PADDED_CUBE_BYTES))},
     lambda r, files: r["decodes"] == files and r["budget_evictions"] > 0 and r["owner_evictions"] == 0),
]


@pytest.mark.parametrize("case,extra,expect", COUNTER_CASES, ids=[c[0] for c in COUNTER_CASES])
def test_runner_counts_decodes_per_miss_and_evictions_by_cause(case, extra, expect, tmp_path):
    """One decode per dataset-cache miss; budget and owner-death evictions of the cube cache told apart."""
    cwd = _archive(tmp_path)
    files = 4 * len(ORBITS)
    env = {k: v for k, v in os.environ.items() if not k.startswith("CST_")}
    env.update(extra, CST_TORCH_DEVICE="cpu", CST_RENDER_BACKEND="device", PYTHONPATH=str(REPO))
    report = tmp_path / "report.json"
    proc = subprocess.run([sys.executable, "-c", chip_smoke.FLAGSHIP_RUNNER, str(report), "1"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    got = json.loads(report.read_text())
    assert got["final"] is True
    assert got["decodes"] == got["dataset_cache"]["misses"]
    assert expect(got, files), got
    assert got["upload"]["upload_bytes"] % chip_smoke.cube_bytes(SHAPE) == 0
    assert len(list((cwd / "FAST_plots").rglob("*.png"))) == len(ORBITS) * 40


def test_phase_seconds_leave_out_the_phases_inside(monkeypatch):
    """The [phases] line's seconds: a phase's own, less those of the phases it ran (``chip_smoke.timed``)."""
    import time

    clock = iter(range(0, 100, 1))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    monkeypatch.setattr(chip_smoke, "PHASE_SECONDS", {})

    def outer():
        chip_smoke.timed("inner", lambda: None)  # 1 s
        chip_smoke.timed("inner", lambda: None)  # 1 s more
        return "done"

    assert chip_smoke.timed("outer", outer) == "done"  # 5 s in all
    assert chip_smoke.PHASE_SECONDS == {"inner": 2.0, "outer": 3.0}
    with pytest.raises(ZeroDivisionError):
        chip_smoke.timed("failing", lambda: 1 / 0)
    assert chip_smoke.PHASE_SECONDS["failing"] == 1.0 and not chip_smoke._PHASE_STACK


def _owned_bytes(arrays) -> int:
    """The bytes *arrays* keep alive: each one's outermost base, counted once."""
    roots = {}
    for a in arrays:
        while isinstance(a.base, type(a)):
            a = a.base
        roots[id(a)] = a.nbytes
    return sum(roots.values())


def test_a_dataset_holds_only_the_bytes_its_cache_counts(tmp_path):
    """A decoded dataset keeps alive no more than ``sum(a.nbytes)``, the bytes ``CST_DATASET_CACHE_BYTES`` budgets.

    The CDF's energy and pitch-angle variables are (T, A, E) broadcasts; a
    view of their first row kept each whole variable alive, so a cached
    8192x64x128 dataset held three cubes (805 MB) where the cache counted
    one (268 MB), and [scale] over real cubes peaked at 11.7 GB of RSS.
    The JAX package keeps the views (the same values).
    """
    import numpy as np
    from configurable_spectrograms_tpu.data import cdf_utils as jcdf

    from configurable_spectrograms_torch.data import cdf_utils
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    path = synth_fast_archive(str(tmp_path), [5000], instruments=("ees",), n_time=SHAPE[0], n_angle=SHAPE[1],
                              n_energy=SHAPE[2])[5000]["ees"]
    names = tuple(cdf_utils.CDF_VARIABLE_NAMES)
    got, want = cdf_utils._decode_fast_cdf(path, names), jcdf._decode_fast_cdf(path, names)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    counted = sum(a.nbytes for a in got.values())
    assert counted == ENTRY_BYTES
    assert _owned_bytes(got.values()) == counted
    assert _owned_bytes(want.values()) == 3 * chip_smoke.cube_bytes(SHAPE) + 8 * SHAPE[0]  # the reference: 3 cubes
