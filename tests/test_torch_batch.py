"""The port's FAST batch driver against the JAX package's, on the CPU.

``FAST_plot_spectrograms_directory`` of both packages runs over one tiny
synthetic archive (2 orbits, 2 instruments) at ``max_workers=1``, where
completion order, and so the progress cursor, is deterministic
(``FAST_plot_spectrograms_multi``, the error taxonomy and the timeout
retry are in tests/test_torch_batch_multi.py, on the same fixtures).  On the host backend the port must
write the JAX package's PNG pixels, progress JSON and extrema JSON; on the
device backend (CPU tensors, the kernels' plain versions) the PNGs may
differ only in cells one colormap bin apart.  The JAX package renders on
its host backend throughout: it is the reference both of the port's
backends are held to.  The rest holds the driver's pieces (the progress
ledger, the stale-tmp sweep, orbit sharding, ``FastBatchConfig``) and the
two repairs (one kernel build under worker threads, the paced gc) to the
JAX package's behaviour.
"""

import dataclasses
import doctest
import importlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_slice import _assert_same_or_one_bin_apart, _assert_same_pixels

torch.set_num_threads(1)

ORBITS = [4100, 4101]
SCALES = [("linear", "linear"), ("log", "log")]
RUN = dict(max_workers=1, max_processing_percentile=95, retry_timeouts=False, use_tqdm=False,
           orbit_timeout_seconds=600, instrument_timeout_seconds=300)


def _pngs(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.png"))}


def _json(path: Path):
    return json.loads(path.read_text()) if path.exists() else None


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("torch_batch")
    mapping = synth_fast_archive(str(root / "data"), ORBITS, instruments=("ees", "ies"), n_time=64, n_angle=8,
                                 n_energy=16, cusp_csv_path=str(root / "cusp.tsv"), seed=5)
    return {"root": root, "data": str(root / "data"), "cusp": str(root / "cusp.tsv"), "mapping": mapping}


def _run(driver, data: str, out: Path, **kw) -> dict:
    """One driver run into *out*: its results, PNG tree, progress JSON and extrema JSON."""
    out.mkdir(parents=True, exist_ok=True)
    results = driver(data, output_base=str(out / "plots"), progress_json_path=str(out / "progress.json"),
                     extrema_json_path=str(out / "extrema.json"), **kw)
    return {"results": results, "pngs": _pngs(out / "plots"), "progress": _json(out / "progress.json"),
            "extrema": _json(out / "extrema.json"), "out": out}


@pytest.fixture(scope="module")
def jax_reference(archive):
    """The JAX package's run for a driver and its arguments, on its host backend (made once per module)."""
    from configurable_spectrograms_tpu.data import cdf_utils as jcdf
    from configurable_spectrograms_tpu.fast import batch_directory as jbd
    from configurable_spectrograms_tpu.render import figure as jfigure

    runs = {}

    def get(driver: str, data: str | None = None, **kw) -> dict:
        key = (driver, data, tuple(sorted(kw.items())))
        if key not in runs:
            with pytest.MonkeyPatch.context() as mp:
                mp.setitem(jfigure._BACKEND, "mode", "host")
                mp.setenv("CST_CUSP_CSV", archive["cusp"])
                mp.setattr(jcdf, "filtered_orbits_cache", {})
                runs[key] = _run(getattr(jbd, driver), data or archive["data"],
                                 archive["root"] / f"jax_{len(runs)}", **kw)
        return runs[key]

    return get


@pytest.fixture
def port(archive, monkeypatch):
    """The port on the CPU with the archive's cusp table; returns a setter for the render backend."""
    from configurable_spectrograms_torch.data import cdf_utils

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_CUSP_CSV", archive["cusp"])
    monkeypatch.setattr(cdf_utils, "filtered_orbits_cache", {})
    return lambda backend: monkeypatch.setenv("CST_RENDER_BACKEND", backend)


def _assert_same_trees(got: dict, want: dict, backend: str) -> None:
    assert list(got) == list(want)
    for path in want:
        if backend == "host":
            _assert_same_pixels(got[path], want[path], path)
        else:
            _assert_same_or_one_bin_apart(got[path], want[path], path)


@pytest.mark.parametrize("scales", SCALES, ids=["linear-linear", "log-log"])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_directory_driver_matches_the_jax_package(backend, scales, archive, jax_reference, port, tmp_path):
    from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_directory

    port(backend)
    y, z = scales
    kw = dict(RUN, y_scale=y, z_scale=z, colormap="inferno")
    want = jax_reference("FAST_plot_spectrograms_directory", **kw)
    got = _run(FAST_plot_spectrograms_directory, archive["data"], tmp_path, **kw)
    assert got["results"] == want["results"]
    assert [r["status"] for r in got["results"]] == ["ok"] * 4  # 2 orbits x raw + given-extrema jobs
    assert len(got["pngs"]) == 2 * 2 * 3  # orbits x given/raw x (2 pitch grids + 1 instrument grid)
    _assert_same_trees(got["pngs"], want["pngs"], backend)
    assert got["progress"] == want["progress"]
    assert got["progress"][f"{y}_{z}_last_orbit"] == ORBITS[-1]
    assert got["extrema"] == want["extrema"]


def _ledger_sequence(mod, path: str, steps: list, flush: int) -> list:
    """Feed one ledger *steps*; after each, the progress file's content (None before the first flush)."""
    ledger = mod._ProgressLedger(path, "linear", "log", flush_batch_size=flush)
    seen = []
    for step in steps:
        if step[0] == "record":
            ledger.record(step[1], step[2])
        elif step[0] == "clear":
            ledger.clear_timeout_flags(step[1])
        else:
            ledger.write(ledger.state(), force=True)
        seen.append(_json(Path(path)))
    seen.append(ledger.load_resume_state(ignore=False))
    return seen


_ERR = "[FAIL] Plotting Orbit {} pitch angle grid for ees"


@pytest.mark.parametrize(
    "steps,flush",
    [
        ([("record", 1, {"status": "ok"}), ("record", 2, {"status": "ok"}), ("record", 3, {"status": "ok"})], 3),
        ([("record", 10, {"status": "error", "errors": [_ERR.format(10), "divide by zero in ies"]}),
          ("record", 11, {"status": "error", "errors": ["Invalid CDF magic"]})], 1),
        ([("record", 5, {"status": "timeout", "timeout_type": "orbit"}),
          ("record", 6, {"status": "timeout", "timeout_type": "instrument", "timeout_instrument": "ieb"}),
          ("record", 7, {"status": "timeout"}), ("clear", 6), ("clear", 5), ("clear", 99)], 1),
        ([("record", 1, {"status": "error", "errors": ["[FAIL] ees exploded"]}),
          ("record", 2, {"status": "timeout", "timeout_type": "orbit"}), ("record", 3, {"status": "ok"}),
          ("record", 4, {"status": "ok"}), ("flush",)], 3),
    ],
    ids=["cadence", "errors", "timeouts-and-clear", "accumulates-between-flushes"],
)
def test_progress_ledger_matches_the_jax_package(steps, flush, tmp_path):
    from configurable_spectrograms_tpu.fast import batch_directory as jbd

    from configurable_spectrograms_torch.fast import batch_directory as bd

    got = _ledger_sequence(bd, str(tmp_path / "port.json"), steps, flush)
    want = _ledger_sequence(jbd, str(tmp_path / "jax.json"), steps, flush)
    assert got == want
    assert any(s is not None for s in got[:-1])


def test_consume_result_records_an_escaped_exception_as_the_jax_package_does(tmp_path):
    """An exception out of the worker: the ``unknown_*`` key beside the error list (reference batch_directory.py:266-290)."""
    import concurrent.futures

    from configurable_spectrograms_tpu.fast import batch_directory as jbd

    from configurable_spectrograms_torch.fast import batch_directory as bd

    states = []
    for mod, name in ((bd, "port"), (jbd, "jax")):
        fut = concurrent.futures.Future()
        fut.set_exception(RuntimeError("timeout while plotting"))
        ledger = mod._ProgressLedger(str(tmp_path / f"{name}.json"), "log", "log", flush_batch_size=1)
        results = []
        mod._consume_result(fut, 42, ledger, results, echo=False)
        assert results == [{"orbit": 42, "status": "error", "errors": ["timeout while plotting"]}]
        states.append(_json(tmp_path / f"{name}.json"))
    assert states[0] == states[1]
    assert states[0]["unknown_log_log_error-timeout"] == [42]


def test_interrupt_escalation_requests_shutdown_then_exits_130(monkeypatch):
    import signal

    from configurable_spectrograms_torch.fast import batch_directory as bd

    monkeypatch.setattr(bd, "terminate_all_child_processes", lambda: None)
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    flag = {"flag": False}
    try:
        bd._install_interrupt_escalation(flag)
        handler = signal.getsignal(signal.SIGTERM)
        assert signal.getsignal(signal.SIGINT) is handler
        with pytest.raises(KeyboardInterrupt):
            handler(signal.SIGTERM, None)
        assert flag["flag"]
        with pytest.raises(SystemExit) as exc:
            handler(signal.SIGINT, None)
        assert exc.value.code == 130
    finally:
        for s, h in saved.items():
            signal.signal(s, h)


@pytest.mark.parametrize("stop_after", [None, 1], ids=["drains", "shutdown"])
def test_job_pool_without_tqdm_drains_or_cancels(stop_after, monkeypatch, capsys):
    """The pool runs with no ``tqdm`` installed; a shutdown request flushes (``on_drained``) and raises."""
    from configurable_spectrograms_torch.fast import batch_directory as bd

    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    monkeypatch.setattr(bd, "tqdm_or_none", lambda: None)
    monkeypatch.setattr(bd, "FAST_process_single_orbit", lambda orbit, *a: {"orbit": orbit, "status": "ok"})
    ledger = bd._ProgressLedger(None, "log", "log", flush_batch_size=1)
    shutdown = {"flag": False}
    results, drained = [], []

    def consume(fut, orbit, ctx):
        assert ctx == f"ctx{orbit}"
        bd._consume_result(fut, orbit, ledger, results, echo=True)
        if stop_after is not None and len(results) >= stop_after:
            shutdown["flag"] = True

    jobs = [((o,), o, f"ctx{o}") for o in range(6)]
    args = (jobs, 2, shutdown, consume, "pool", True)
    if stop_after is None:
        bd._run_job_pool(*args, on_drained=lambda: drained.append(True))
        assert sorted(r["orbit"] for r in results) == list(range(6))
    else:
        with pytest.raises(KeyboardInterrupt):
            bd._run_job_pool(*args, on_drained=lambda: drained.append(True))
        assert 1 <= len(results) <= 6
    assert drained == [True]
    assert f"[BATCH] Completed orbit {results[0]['orbit']}: ok" in capsys.readouterr().out


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait(timeout=60)
    return proc.pid


@pytest.mark.parametrize("case", ["dead_pid", "live_recent", "live_ancient", "unparseable", "not_a_tmp"])
def test_stale_tmp_sweep(case, tmp_path):
    """A dead owner's tmp is swept, a live and recent one kept, an ancient one swept (age rule alone for odd names)."""
    from configurable_spectrograms_torch.fast import batch_directory as bd

    out = tmp_path / "plots" / "2001" / "01" / "3000"
    out.mkdir(parents=True)
    name = {
        "dead_pid": f"3000_x.png.tmp-{_dead_pid()}-456",
        "live_recent": f"3000_x.png.tmp-{os.getpid()}-789",
        "live_ancient": f"3000_x.png.tmp-{os.getpid()}-789",
        "unparseable": "3000_y.png.tmp-notapid",
        "not_a_tmp": "3000_x.png",
    }[case]
    f = out / name
    f.write_bytes(b"partial")
    if case == "live_ancient":
        old = f.stat().st_mtime - bd._STALE_TMP_AGE_SEC - 10
        os.utime(f, (old, old))
    bd._sweep_stale_tmp(str(tmp_path / "plots"))
    assert f.exists() == (case in ("live_recent", "not_a_tmp"))
    bd._sweep_stale_tmp(str(tmp_path / "missing"))  # no-op, no raise


@pytest.mark.parametrize("shard", [(0, 1), (1, 3), (2, 3)])
def test_orbit_sharding_and_per_process_paths_match_the_jax_package(shard, monkeypatch):
    from configurable_spectrograms_tpu.fast import batch_directory as jbd
    from configurable_spectrograms_tpu.parallel.mesh import set_process_shard

    from configurable_spectrograms_torch.fast import batch_directory as bd

    monkeypatch.setattr(bd, "_process_shard_info", lambda: shard)
    orbits = list(range(100, 111))
    set_process_shard(*shard)
    try:
        want = (jbd._shard_orbits_across_processes(orbits), jbd._per_process_path("p.json"),
                jbd._per_process_path(None))
    finally:
        set_process_shard(0, 1)
    assert (bd._shard_orbits_across_processes(orbits), bd._per_process_path("p.json"),
            bd._per_process_path(None)) == want


def test_process_shard_info_reads_torch_distributed():
    """``(0, 1)`` alone, and the process group's rank and size once one is initialised."""
    import socket

    import torch.distributed as dist

    from configurable_spectrograms_torch.fast.batch_directory import _process_shard_info

    assert _process_shard_info() == (0, 1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        assert _process_shard_info() == (0, 1)
    finally:
        dist.destroy_process_group()


def test_fast_batch_config_fields_and_defaults_match_the_jax_package():
    from configurable_spectrograms_tpu.utils import config as jconfig

    from configurable_spectrograms_torch.utils import config

    def plain(value):
        if isinstance(value, tuple):
            return tuple(plain(v) for v in value)
        return dataclasses.astuple(value) if dataclasses.is_dataclass(value) else value

    def fields(cls):
        return [(f.name, plain(f.default if f.default is not dataclasses.MISSING else f.default_factory()))
                for f in dataclasses.fields(cls)]

    assert fields(config.FastBatchConfig) == fields(jconfig.FastBatchConfig)
    assert fields(config.ScaleCombo) == fields(jconfig.ScaleCombo)
    assert [dataclasses.astuple(c) for c in config.DEFAULT_SCALE_COMBOS] == [
        dataclasses.astuple(c) for c in jconfig.DEFAULT_SCALE_COMBOS]
    cfg = config.FastBatchConfig()
    assert cfg.replace(max_workers=2).max_workers == 2 and cfg.max_workers == 4


@pytest.mark.parametrize(
    "schedule,n_combos,calls",
    [("orbit-major", 4, ["multi"]), ("orbit-major", 1, ["directory"]), ("combo-major", 2, ["directory"] * 2)],
)
def test_fast_batch_config_schedule_dispatch(schedule, n_combos, calls, monkeypatch):
    from configurable_spectrograms_torch.fast import batch_directory as bd
    from configurable_spectrograms_torch.utils.config import DEFAULT_SCALE_COMBOS, FastBatchConfig

    seen = []
    monkeypatch.setattr(bd, "FAST_plot_spectrograms_multi",
                        lambda d, combos, **kw: seen.append("multi") or [{"combos": len(combos)}])
    monkeypatch.setattr(bd, "FAST_plot_spectrograms_directory",
                        lambda d, y_scale, z_scale, colormap, **kw: seen.append("directory") or [(y_scale, z_scale)])
    combos = DEFAULT_SCALE_COMBOS[:n_combos]
    results = FastBatchConfig(combos=combos, schedule=schedule).run()
    assert seen == calls
    if calls == ["multi"]:
        assert results == [{"combos": n_combos}]
    else:
        assert results == [(c.y_scale, c.z_scale) for c in combos]


def test_fast_batch_config_rejects_an_unknown_schedule():
    from configurable_spectrograms_torch.utils.config import FastBatchConfig

    with pytest.raises(ValueError, match="schedule"):
        FastBatchConfig(schedule="sideways").run()


@pytest.mark.parametrize(
    "msg",
    ["divide by zero encountered", "Invalid CDF file", "Timeout while processing orbit", "[FAIL] Plotting x",
     "something else entirely", "", "DIVIDE ... ZERO", "invalid plot"],
)
def test_classify_error_reason_matches_the_jax_package(msg):
    from configurable_spectrograms_tpu.data.orbit_discovery import classify_error_reason as want

    from configurable_spectrograms_torch.data.orbit_discovery import classify_error_reason

    assert classify_error_reason(msg) == want(msg)


_DAY = {
    "eeb": ["fa_esa_l2_eeb_20000101001737_100_v02.cdf", "fa_esa_l2_eeb_20000101031737_101_v02.cdf"],
    "ies": ["fa_esa_l2_ies_20000101001738_100_v02.cdf", "fa_esa_l2_ies_20000101031738_101_v02.cdf"],
    "ees": ["fa_esa_l2_ees_20000101031737_101_v02.cdf", "fa_k0_orb_101_v01.cdf", "junk.cdf"],
}


@pytest.mark.parametrize(
    "fn,arg",
    [
        ("resolve_shared_orbit", _DAY),
        ("resolve_shared_orbit", {k: v[:1] for k, v in _DAY.items()}),
        ("resolve_shared_orbit", {"eeb": [], "ies": []}),
        ("resolve_orbit_from_files", {"eeb": "fa_esa_l2_eeb_20000101001737_13312_v02.cdf"}),
        ("resolve_orbit_from_files", {"x": "not_a_fast_file.cdf", "ies": "fa_esa_l2_ies_2000_77_v02.cdf"}),
        ("resolve_orbit_from_files", {}),
    ],
)
def test_orbit_resolution_matches_the_jax_package(fn, arg):
    from configurable_spectrograms_tpu.data import orbit_discovery as jod

    from configurable_spectrograms_torch.data import orbit_discovery as od

    assert getattr(od, fn)(arg) == getattr(jod, fn)(arg)


@pytest.mark.parametrize(
    "args",
    [dict(), dict(low_percentile=5, high_percentile=95), dict(z_min=-5.0), dict(z_max=3.0),
     dict(z_min=1.0, z_max=2.0, low_percentile=0, high_percentile=100)],
)
def test_compute_percentile_bounds_matches_the_jax_package(args):
    from configurable_spectrograms_tpu.utils.percentiles import compute_percentile_bounds as want

    from configurable_spectrograms_torch.utils.percentiles import compute_percentile_bounds

    m = np.random.default_rng(9).random((40, 12)) * 100.0
    m[m < 5] = np.nan
    assert compute_percentile_bounds(m, **args) == want(m, **args)


def test_cdf_var_shapes_match_the_jax_package(archive):
    from configurable_spectrograms_tpu.data.cdf_utils import get_cdf_var_shapes as jshapes
    from configurable_spectrograms_tpu.data.cdf_utils import get_variable_shape as jshape

    from configurable_spectrograms_torch.data.cdf_utils import get_cdf_var_shapes, get_variable_shape

    names = ["data", "energy", "time_unix", "no_such_variable"]
    got = get_cdf_var_shapes(archive["data"], names)
    assert got == jshapes(archive["data"], names)
    assert sorted(got["data"]) == [(64, 8, 16)] * 4 and got["no_such_variable"] == [None] * 4
    path = archive["mapping"][ORBITS[0]]["ies"]
    assert get_variable_shape(path, "pitch_angle") == jshape(path, "pitch_angle")
    assert get_variable_shape("fa_k0_orb_13312_v01.cdf", "data") is None


@pytest.mark.parametrize("module", ["data.orbit_discovery", "utils.percentiles", "utils.timing", "data.download"])
def test_port_doctests(module):
    mod = importlib.import_module(f"configurable_spectrograms_torch.{module}")
    result = doctest.testmod(mod)
    assert result.attempted > 0 and result.failed == 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from configurable_spectrograms_torch.utils.timing import StageTimer, device_trace

    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64).sum()
    (trace,) = (tmp_path / "trace").glob("trace-*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    timer = StageTimer("t")
    threads = [threading.Thread(target=lambda: [timer.add("s", 1.0) for _ in range(500)]) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert timer.totals == {"s": 2000.0} and timer.counts == {"s": 2000}


def test_load_library_builds_once_under_concurrent_first_use(monkeypatch):
    """Four threads reach their first kernel together: one build, one library for all."""
    import time
    import types

    from configurable_spectrograms_torch.ops import _build

    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return Path("stub.so")

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "_LIBRARY", [])
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(**{n: types.SimpleNamespace() for n in _build._SIGNATURES}))
    gate = threading.Barrier(4)
    libs = []

    def first_use():
        gate.wait(timeout=30)
        libs.append(_build.load_library())

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert libs[0].cst_collapse.restype is _build.ctypes.c_int


def test_launch_counts_survive_concurrent_launches(monkeypatch):
    from configurable_spectrograms_torch.ops import kernels

    monkeypatch.setattr(kernels, "LAUNCHES", {"collapse": 0, "fused_quantize": 0, "stft_power": 0})
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels._count_launch("collapse") for _ in range(2000)])
                   for _ in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert kernels.LAUNCHES["collapse"] == 2000 * len(threads)


def test_paced_gc_limits_full_collections(monkeypatch):
    """The port paces the per-orbit gc as the JAX package does (tests/test_fast_layer.py:322-353)."""
    import gc as gc_mod

    from configurable_spectrograms_torch.fast import process_orbit as po

    calls = []
    monkeypatch.setattr(gc_mod, "collect", lambda *a: calls.append(a))
    fake_now = [1000.0]
    monkeypatch.setattr(po.time, "monotonic", lambda: fake_now[0])
    monkeypatch.setattr(po, "_GC_FULL_INTERVAL_S", 20.0)
    monkeypatch.setattr(po, "_GC_LAST_FULL", [0.0])
    po._paced_gc()  # stale last_full: full pass
    po._paced_gc()  # within the interval: young-gen only
    fake_now[0] += 25.0
    po._paced_gc()  # interval elapsed: full pass again
    assert calls == [(), (1,), ()]
    calls.clear()
    monkeypatch.setattr(po, "_GC_FULL_INTERVAL_S", 0.0)
    po._paced_gc()
    po._paced_gc()
    assert calls == [(), ()]  # the reference's cadence: every call is full


@pytest.mark.parametrize("value,want", [("20s", 20.0), ("", 0.0), ("7.5", 7.5)])
def test_gc_interval_env_parse_matches_the_jax_package(value, want):
    """A malformed ``CST_GC_FULL_INTERVAL_S`` falls back to the default, as in the JAX package."""
    code = ("from configurable_spectrograms_torch.fast import process_orbit as m; print(m._GC_FULL_INTERVAL_S)\n"
            "import sys; assert not any(k.startswith('jax') for k in sys.modules)")
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=str(repo),
                         env={**os.environ, "CST_GC_FULL_INTERVAL_S": value})
    assert out.returncode == 0, out.stderr
    assert float(out.stdout.strip()) == want
