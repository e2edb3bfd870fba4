"""The port over an archive with corrupt CDFs, and killed mid-run and resumed, on the CPU.

The CPU half of ``chip_smoke.py``'s ``[scale]`` phase, at tiny shapes:

* each fault of tools/scale_run.py (a truncated, a garbage-header and a
  zero-length CDF), put in by ``chip_smoke.inject_faults``, goes through
  the extrema pre-pass and the render of the orbit-major flagship driver
  of both packages: the same results, progress JSON (error keys
  included) and extrema JSON, and the same PNG files (pixel for pixel on
  the host backend, within one colormap bin on the device backend, which
  renders the good orbits of one faulted archive: a fault fails the read,
  before any backend);
* the batch ledger's cursor passes an orbit only once all its jobs
  finished (the JAX package's is the orbit of the last finished job): out
  of order at several workers, and with the process dead between an
  orbit's raw and given-extrema jobs, whose resume must redo that orbit;
* the port's flagship CLI (``chip_smoke.FLAGSHIP_RUNNER``) at one worker,
  over one orbit, is ``SIGKILL``ed after its first PNG lands and run
  twice more: the PNGs equal an uninterrupted run's
  byte for byte (docs/parity.md's contract at one worker), no ``*.tmp-*``
  file remains and the third run writes nothing.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from test_torch_batch import _assert_same_trees, _run

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ORBITS = [4100, 4101, 4102]
INSTRUMENTS = ("ees", "eeb", "ies")
SHAPE = dict(n_time=64, n_angle=8, n_energy=16)
COMBOS = (("log", "log", "inferno"),)  # the flagship's driver at one combo (its four are ~4x the seconds)
CLI_ORBITS, CLI_INSTRUMENTS = ORBITS[:1], INSTRUMENTS[::2]  # the CLI runs all four combos, four times
RUN = dict(max_workers=1, max_processing_percentile=99, retry_timeouts=False, use_tqdm=False,
           orbit_timeout_seconds=600, instrument_timeout_seconds=300, combos=COMBOS)
#: One case per fault of ``chip_smoke.SCALE_FAULTS``, on the archive's middle orbit.
FAULTS = {kind: (1, inst, kind) for _, inst, kind in chip_smoke.SCALE_FAULTS}
#: Every fault on the host backend; the device backend over one of them (the faulted file fails its read, so the
#: backend renders only the good orbits, the same in every case).
CASES = [(kind, "host") for kind in FAULTS] + [("garbage", "device")]


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("torch_scale")
    synth_fast_archive(str(root / "clean"), ORBITS, instruments=INSTRUMENTS, cusp_csv_path=str(root / "cusp.tsv"),
                       seed=9, **SHAPE)
    synth_fast_archive(str(root / "cli"), CLI_ORBITS, instruments=CLI_INSTRUMENTS,
                       cusp_csv_path=str(root / "cli_cusp.tsv"), seed=9, **SHAPE)
    return root


def _faulted_copy(archive: Path, kind: str) -> tuple[str, dict]:
    """A copy of the archive with one fault (made once per kind); its path and the fault injected."""
    from configurable_spectrograms_torch.data.orbit_discovery import discover_orbit_files

    data = archive / kind
    if not data.exists():
        shutil.copytree(archive / "clean", data)
        mapping = discover_orbit_files(str(data))
        (archive / f"{kind}.json").write_text(json.dumps(chip_smoke.inject_faults(mapping, [FAULTS[kind]], seed=11)))
    return str(data), json.loads((archive / f"{kind}.json").read_text())[0]


@pytest.fixture(scope="module")
def jax_runs(archive):
    """The JAX package's flagship driver over a faulted copy, on its host backend (once per fault)."""
    from configurable_spectrograms_tpu.data import cdf_utils as jcdf
    from configurable_spectrograms_tpu.fast import batch_directory as jbd
    from configurable_spectrograms_tpu.render import figure as jfigure

    runs = {}

    def get(kind: str) -> dict:
        if kind not in runs:
            data, _ = _faulted_copy(archive, kind)
            with pytest.MonkeyPatch.context() as mp:
                mp.setitem(jfigure._BACKEND, "mode", "host")
                mp.setenv("CST_CUSP_CSV", str(archive / "cusp.tsv"))
                mp.setattr(jcdf, "filtered_orbits_cache", {})
                runs[kind] = _run(jbd.FAST_plot_spectrograms_multi, data, archive / f"jax_{kind}", **RUN)
        return runs[kind]

    return get


@pytest.mark.parametrize("kind,backend", CASES, ids=[f"{kind}-{backend}" for kind, backend in CASES])
def test_faulted_archive_matches_the_jax_package(kind, backend, archive, jax_runs, monkeypatch, tmp_path):
    from configurable_spectrograms_torch.data import cdf_utils
    from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_multi

    data, fault = _faulted_copy(archive, kind)
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    monkeypatch.setenv("CST_CUSP_CSV", str(archive / "cusp.tsv"))
    monkeypatch.setattr(cdf_utils, "filtered_orbits_cache", {})
    want = jax_runs(kind)
    got = _run(FAST_plot_spectrograms_multi, data, tmp_path, **RUN)
    assert got["results"] == want["results"]
    assert got["progress"] == want["progress"]
    assert got["extrema"] == want["extrema"]
    # Equal bytes need no decoding (a 200-DPI canvas takes ~0.4 s to decode here).
    assert list(got["pngs"]) == list(want["pngs"])
    differ = [path for path in want["pngs"] if got["pngs"][path] != want["pngs"][path]]
    _assert_same_trees({p: got["pngs"][p] for p in differ}, {p: want["pngs"][p] for p in differ}, backend)
    # The faulted orbit, and only it, is in every combo's error keys; the others rendered all their figures.
    flagged = {o for k, v in got["progress"].items() if "error" in k and isinstance(v, list) for o in v}
    assert flagged == {fault["orbit"]}
    for y, z, _ in COMBOS:
        assert got["progress"][f"{y}_{z}_error_plotting"] == [fault["orbit"]]
        assert got["progress"][f"{fault['instrument']}_{y}_{z}_error-generic"] == [fault["orbit"]]
    good = [o for o in ORBITS if o != fault["orbit"]]
    per_orbit = len(COMBOS) * 2 * (len(INSTRUMENTS) + 1)  # combos x given/raw x (pitch grids + instrument grid)
    assert sum(f"/{o}/" in f"/{p}" for p in got["pngs"] for o in good) == len(good) * per_orbit


def _ledger_cursors(mod, path: Path, completions: list[int], expect: bool) -> list:
    """The on-disk cursor after each completed job (flushed every job); the port's ledger is told the run's jobs."""
    ledger = mod._ProgressLedger(str(path), "log", "log", flush_batch_size=1)
    if expect:
        ledger.expect(sorted(completions))
    seen = []
    for orbit in completions:
        ledger.record(orbit, {"status": "ok"})
        seen.append(json.loads(path.read_text()).get("log_log_last_orbit"))
    return seen


def test_cursor_passes_an_orbit_only_once_all_its_jobs_finished(tmp_path):
    """Out-of-order completions at several workers: the reference's cursor jumps past unfinished orbits, the port's does not."""
    from configurable_spectrograms_tpu.fast import batch_directory as jbd

    from configurable_spectrograms_torch.fast import batch_directory as bd

    # Two jobs an orbit (raw, given); the raw jobs of 4101 and 4102 finish before 4100's given job.
    order = [4100, 4101, 4102, 4100, 4102, 4101]
    assert _ledger_cursors(jbd, tmp_path / "jax.json", order, expect=False) == order  # the reference's rule
    assert _ledger_cursors(bd, tmp_path / "port.json", order, expect=True) == [None, None, None, 4100, 4100, 4102]
    assert _ledger_cursors(bd, tmp_path / "port_plain.json", order, expect=False) == order  # nothing expected


class _Killed(BaseException):
    """The process dies: raised by a job and by every job after it, caught by no driver."""


def _killed_at(monkeypatch, mod, orbit: int) -> None:
    """Make *mod*'s driver die in *orbit*'s given-extrema job (the one with global extrema); no later job runs.

    The job dies once the driver has folded the orbit's raw job into its
    ledger, so the kill lands between the orbit's two jobs.
    """
    import inspect
    import threading

    real_job, real_consume = mod.FAST_process_single_orbit, mod._consume_result
    raw_folded, dead = threading.Event(), []

    def job(*args, **kw):
        given = inspect.signature(real_job).bind(*args, **kw).arguments.get("global_extrema") is not None
        if dead or (args[0] == orbit and given):
            dead.append(args[0])
            assert raw_folded.wait(timeout=120)
            raise _Killed
        return real_job(*args, **kw)

    def consume(fut, orbit_done, *args, **kw):
        real_consume(fut, orbit_done, *args, **kw)
        if orbit_done == orbit:
            raw_folded.set()

    monkeypatch.setattr(mod, "FAST_process_single_orbit", job)
    monkeypatch.setattr(mod, "_consume_result", consume)


def test_a_kill_inside_an_orbit_resumes_that_orbit(archive, monkeypatch, tmp_path):
    """One worker, flushed every job, dead in orbit 4101's given job: the port's resume redoes 4101.

    The reference's cursor already names 4101 after its raw job, so its
    resume skips the orbit and 4101's given-extrema files keep the raw
    job's content (docs/parity.md, the progress cursor).
    """
    from configurable_spectrograms_tpu.data import cdf_utils as jcdf
    from configurable_spectrograms_tpu.fast import batch_directory as jbd
    from configurable_spectrograms_tpu.render import figure as jfigure

    from configurable_spectrograms_torch.data import cdf_utils
    from configurable_spectrograms_torch.fast import batch_directory as bd

    data = str(archive / "clean")
    kw = dict(RUN, flush_batch_size=1)
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    monkeypatch.setenv("CST_CUSP_CSV", str(archive / "cusp.tsv"))
    monkeypatch.setattr(cdf_utils, "filtered_orbits_cache", {})
    monkeypatch.setattr(jcdf, "filtered_orbits_cache", {})
    monkeypatch.setitem(jfigure._BACKEND, "mode", "host")
    want = _run(bd.FAST_plot_spectrograms_multi, data, tmp_path / "uninterrupted", **kw)["pngs"]

    runs = {}
    for name, mod in (("port", bd), ("jax", jbd)):
        with monkeypatch.context() as mp:
            _killed_at(mp, mod, ORBITS[1])
            with pytest.raises(_Killed):
                _run(mod.FAST_plot_spectrograms_multi, data, tmp_path / name, **kw)
        runs[name] = json.loads((tmp_path / name / "progress.json").read_text())["log_log_last_orbit"]
    assert runs == {"port": ORBITS[0], "jax": ORBITS[1]}

    got = _run(bd.FAST_plot_spectrograms_multi, data, tmp_path / "port", **kw)
    assert [r["orbit"] for r in got["results"]] == [ORBITS[1]] * 2 + [ORBITS[2]] * 2
    assert got["pngs"] == want


def _cli(cwd: Path, run: int) -> subprocess.Popen:
    """Start the CLI at one worker in *cwd*; its output goes to ``run{run}.out`` beside it, its launch report too."""
    env = dict(os.environ, CST_TORCH_DEVICE="cpu", CST_RENDER_BACKEND="device", PYTHONPATH=str(REPO))
    env.pop("CST_CUSP_CSV", None)
    report = str(cwd.parent / f"{cwd.name}_launches.json")
    with open(cwd.parent / f"{cwd.name}_run{run}.out", "w") as out:
        return subprocess.Popen([sys.executable, "-c", chip_smoke.FLAGSHIP_RUNNER, report, "1"], cwd=cwd, env=env,
                                stdout=out, stderr=subprocess.STDOUT)


def _finish(proc: subprocess.Popen, cwd: Path, run: int) -> dict:
    """Wait for a CLI run that must exit 0; its launch report."""
    assert proc.wait(timeout=300) == 0, (cwd.parent / f"{cwd.name}_run{run}.out").read_text()[-4000:]
    return json.loads((cwd.parent / f"{cwd.name}_launches.json").read_text())


def _cwd(archive: Path, path: Path) -> Path:
    path.mkdir()
    shutil.copytree(archive / "cli", path / "FAST_data")
    shutil.copy(archive / "cli_cusp.tsv", path / "FAST_Cusp_Indices.csv")
    return path


def _tree(cwd: Path) -> dict[str, tuple[int, int]]:
    """Every file the CLI writes (all but the archive, the cusp table and the log): its size and mtime."""
    return {str(p.relative_to(cwd)): (p.stat().st_size, p.stat().st_mtime_ns) for p in sorted(cwd.rglob("*"))
            if p.is_file() and "FAST_data" not in p.parts and p.suffix != ".log"
            and p.name != "FAST_Cusp_Indices.csv"}


def test_cli_killed_mid_run_resumes_to_the_uninterrupted_pngs(archive, tmp_path):
    """SIGKILL after the first PNG, then two runs: the uninterrupted run's PNG bytes, no tmp file, a no-op third run."""
    clean, cwd = _cwd(archive, tmp_path / "uninterrupted"), _cwd(archive, tmp_path / "killed")
    uninterrupted, proc = _cli(clean, 1), _cli(cwd, 1)
    deadline = time.monotonic() + 300
    while not any((cwd / "FAST_plots").rglob("*.png")):
        assert proc.poll() is None and time.monotonic() < deadline, "run 1 ended before its first PNG"
        time.sleep(0.005)
    proc.send_signal(signal.SIGKILL)
    assert proc.wait(timeout=60) == -signal.SIGKILL
    landed = len(list((cwd / "FAST_plots").rglob("*.png")))
    _finish(uninterrupted, clean, 1)
    want = {str(p.relative_to(clean)): p.read_bytes() for p in sorted((clean / "FAST_plots").rglob("*.png"))}
    assert len(want) == len(CLI_ORBITS) * 4 * 2 * (len(CLI_INSTRUMENTS) + 1)  # orbits x 4 combos x given/raw x figures
    assert 0 < landed < len(want)

    report = _finish(_cli(cwd, 2), cwd, 2)
    got = {str(p.relative_to(cwd)): p.read_bytes() for p in sorted((cwd / "FAST_plots").rglob("*.png"))}
    assert got == want
    assert not list(cwd.rglob("*.tmp-*"))
    assert report["launches"]["collapse"] == 0 and report["upload"]["dispatches"] > 0  # CPU tensors launch nothing

    before = _tree(cwd)
    progress = (cwd / "batch_multi_plot_FAST_progress.json").read_text()
    report = _finish(_cli(cwd, 3), cwd, 3)
    after = _tree(cwd)
    # The third run adds, removes and rewrites nothing: the ledger's closing write puts back the same progress JSON.
    assert (cwd / "batch_multi_plot_FAST_progress.json").read_text() == progress
    after.pop("batch_multi_plot_FAST_progress.json"), before.pop("batch_multi_plot_FAST_progress.json")
    assert after == before
    assert report["upload"].get("dispatches", 0) == 0 and sum(report["launches"].values()) == 0
