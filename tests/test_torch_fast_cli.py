"""The port's FAST CLIs, the batch re-export shim and the download CLIs against the JAX package's, on the CPU.

Each mode of the single-figure FAST CLI must write the JAX root CLI's
pixels on the host backend (each package encodes with its own writer), and every usage error must exit as the root
CLI does (0 saved, 1 nothing to plot, 2 usage).  The flagless flagship
CLI runs in a working directory laid out as ``./FAST_data/`` +
``./FAST_Cusp_Indices.csv``, as the root CLI does.  The download CLIs are
driven with their network functions replaced: nothing here touches the
network.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_slice import _assert_same_pixels

REPO = Path(__file__).resolve().parents[1]
ORBIT = 4300

torch.set_num_threads(1)


def _run_main(monkeypatch, main, argv) -> int:
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    try:
        rc = main()
    except SystemExit as exc:
        rc = exc.code
    return 0 if rc is None else rc


@pytest.fixture(scope="module")
def archive(tmp_path_factory) -> dict:
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("fast_cli")
    mapping = synth_fast_archive(str(root / "data"), [ORBIT], instruments=("ees", "ies"), n_time=72, n_angle=8,
                                 n_energy=16, cusp_csv_path=str(root / "cusp.tsv"), seed=13)
    return {"root": root, "data": str(root / "data"), "cusp": str(root / "cusp.tsv"), "files": mapping[ORBIT]}


@pytest.fixture
def host_backends(archive, monkeypatch):
    """Both packages on their host backends, the archive's cusp table, no network."""
    from configurable_spectrograms_tpu.data import cdf_utils as jcdf
    from configurable_spectrograms_tpu.data import download as jdl
    from configurable_spectrograms_tpu.render import figure as jfigure

    from configurable_spectrograms_torch.data import cdf_utils
    from configurable_spectrograms_torch.data import download as dl

    monkeypatch.setitem(jfigure._BACKEND, "mode", "host")
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_CUSP_CSV", archive["cusp"])
    for mod in (cdf_utils, jcdf):
        monkeypatch.setattr(mod, "filtered_orbits_cache", {})

    def offline(*a, **k):
        raise AssertionError("a test touched the network")

    for mod in (dl, jdl):
        monkeypatch.setattr(mod, "_list_instrument_page_files", offline)
        monkeypatch.setattr(mod, "_download_single_cdf_file", offline)


def _fake_day_download(files: dict, calls: list):
    def download(date, instruments, data_folder):
        calls.append((date.isoformat(), tuple(instruments), data_folder))
        return {inst: [files[inst]] if inst in files else [] for inst in instruments}

    return download


@pytest.mark.parametrize("mode", ["cdf-file", "data-folder", "instrument-file", "date"])
def test_single_fast_cli_writes_the_jax_root_clis_bytes(mode, archive, host_backends, tmp_path, monkeypatch):
    import single_plot_FAST_spectrograms as jcli
    from configurable_spectrograms_tpu.data import download as jdl

    from configurable_spectrograms_torch.cli import single_plot_FAST_spectrograms as cli
    from configurable_spectrograms_torch.data import download as dl

    files = archive["files"]
    args = {
        "cdf-file": ["--cdf-file", files["ies"], "--y-scale", "log", "--z-scale", "log", "--colormap", "inferno"],
        "data-folder": ["--data-folder", archive["data"], "--orbit", str(ORBIT), "--cusp-style", "line"],
        "instrument-file": ["--instrument-file", f"ies={files['ies']}", "--instrument-file", f" ees = {files['ees']}",
                            "--z-scale", "log"],
        "date": ["--date", "2000-06-01", "--download-folder", str(tmp_path / "dl"), "--y-scale", "log"],
    }[mode]
    calls = []
    for mod in (dl, jdl):
        monkeypatch.setattr(mod, "download_single_day_cdf", _fake_day_download(files, calls))
    out, ref = tmp_path / "port.png", tmp_path / "jax.png"
    assert _run_main(monkeypatch, cli.main, [*args, "--output", str(out)]) == 0
    assert _run_main(monkeypatch, jcli.main, [*args, "--output", str(ref)]) == 0
    _assert_same_pixels(out.read_bytes(), ref.read_bytes(), mode)
    if mode == "date":
        want = ("2000-06-01", ("ees", "eeb", "ies", "ieb"), str(tmp_path / "dl"))
        assert calls == [want, want]


@pytest.mark.parametrize(
    "argv,code",
    [
        (["--data-folder", "{data}", "--orbit", "999"], 1),
        (["--instrument-file", "ees={missing}"], 1),
        (["--date", "2000-06-01"], 1),
        (["--data-folder", "{data}"], 2),
        (["--cdf-file", "{ees}", "--data-folder", "{data}"], 2),
        (["--instrument-file", "ees"], 2),
        (["--date", "2000-06-01", "--instrument-file", "ees={ees}"], 2),
        ([], 2),
        (["--cdf-file", "{ees}", "--z-scale", "sqrt"], 2),
        (["--cdf-file", "{ees}", "--orbit", "x"], 2),
    ],
)
def test_single_fast_cli_exit_codes_match_the_jax_root_cli(argv, code, archive, host_backends, tmp_path,
                                                           monkeypatch):
    """0 saved, 1 nothing to plot, 2 usage: a missing --orbit and combined modes included."""
    import single_plot_FAST_spectrograms as jcli
    from configurable_spectrograms_tpu.data import download as jdl

    from configurable_spectrograms_torch.cli import single_plot_FAST_spectrograms as cli
    from configurable_spectrograms_torch.data import download as dl

    subs = {"data": archive["data"], "ees": archive["files"]["ees"], "missing": str(tmp_path / "nope.cdf")}
    for mod in (dl, jdl):  # a day with no files
        monkeypatch.setattr(mod, "download_single_day_cdf", _fake_day_download({}, []))
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        out = tmp_path / f"{name}.png"
        rc = _run_main(monkeypatch, main, [a.format(**subs) for a in argv] + ["--output", str(out)])
        assert rc == code, name
        assert out.exists() == (code == 0)


def _cwd_layout(archive: dict, root: Path) -> Path:
    root.mkdir()
    shutil.copytree(archive["data"], root / "FAST_data")
    shutil.copy(archive["cusp"], root / "FAST_Cusp_Indices.csv")
    return root


def test_flagship_cli_in_a_cwd_layout_matches_the_jax_root_cli(archive, host_backends, tmp_path, monkeypatch):
    """The flagless flagship CLI: the root CLI's file list, raw PNG bytes, extrema JSON and progress.

    It runs its defaults (4 combos, orbit-major, a 99th-percentile extrema
    pre-pass, 4 worker threads), so which of a raw-args and a given-extrema
    job writes a ``given_extrema`` name last is a race: only the file
    list and the ``raw``-named files (deterministic) are compared, by
    decoded pixels.
    """
    import batch_multi_plot_FAST_spectrograms as jcli
    from configurable_spectrograms_tpu.utils import logging as jlogging

    from configurable_spectrograms_torch.cli import batch_multi_plot_FAST_spectrograms as cli
    from configurable_spectrograms_torch.utils import logging as tlogging

    monkeypatch.delenv("CST_CUSP_CSV")  # the CLI reads ./FAST_Cusp_Indices.csv
    monkeypatch.delenv("CST_BATCH_SCHEDULE", raising=False)
    trees = {}
    for name, main, logging in (("port", cli.main, tlogging), ("jax", jcli.main, jlogging)):
        monkeypatch.chdir(_cwd_layout(archive, tmp_path / name))
        try:
            assert _run_main(monkeypatch, main, []) == 0
        finally:
            logging.flush_log_buffer()
            logging.set_logfile_path(None)
        cwd = tmp_path / name
        trees[name] = {
            "pngs": {str(p.relative_to(cwd)): p.read_bytes() for p in sorted((cwd / "FAST_plots").rglob("*.png"))},
            "progress": json.loads((cwd / "batch_multi_plot_FAST_progress.json").read_text()),
            "extrema": json.loads((cwd / "FAST_calculated_extrema.json").read_text()),
            "logs": sorted(p.name.startswith("batch_multi_plot_FAST_log") for p in cwd.glob("*.log")),
        }
    port, jax = trees["port"], trees["jax"]
    assert list(port["pngs"]) == list(jax["pngs"])
    assert len(port["pngs"]) == 4 * 2 * 3  # combos x given/raw x (2 pitch grids + 1 instrument grid)
    raw = [p for p in jax["pngs"] if "_raw-" in p]
    assert len(raw) == 4 * 3
    for p in raw:
        _assert_same_pixels(port["pngs"][p], jax["pngs"][p], p)
    assert port["extrema"] == jax["extrema"]
    assert port["progress"] == jax["progress"]
    assert sorted(k for k in port["progress"] if k.endswith("_last_orbit")) == [
        "linear_linear_last_orbit", "linear_log_last_orbit", "log_linear_last_orbit", "log_log_last_orbit"]
    assert all(port["progress"][k] == ORBIT for k in port["progress"] if k.endswith("_last_orbit"))
    assert port["logs"] == jax["logs"] == [True]


@pytest.mark.parametrize("env,schedule", [(None, "orbit-major"), ("", "orbit-major"), ("combo-major", "combo-major")])
def test_flagship_cli_schedule_knob(env, schedule, tmp_path, monkeypatch):
    """``CST_BATCH_SCHEDULE`` picks the schedule of the flagless CLI (default orbit-major)."""
    from configurable_spectrograms_torch.cli import batch_multi_plot_FAST_spectrograms as cli
    from configurable_spectrograms_torch.utils.logging import flush_log_buffer, set_logfile_path

    monkeypatch.chdir(tmp_path)
    if env is None:
        monkeypatch.delenv("CST_BATCH_SCHEDULE", raising=False)
    else:
        monkeypatch.setenv("CST_BATCH_SCHEDULE", env)
    captured = {}

    class _Cfg:
        def __init__(self, **kw):
            captured.update(kw)

        def run(self):
            return []

    monkeypatch.setattr(cli, "FastBatchConfig", _Cfg)
    try:
        assert cli.main() is None
    finally:
        flush_log_buffer()
        set_logfile_path(None)
    assert captured == {"schedule": schedule}


def test_flagship_cli_reraises_an_interrupt(tmp_path, monkeypatch):
    from configurable_spectrograms_torch.cli import batch_multi_plot_FAST_spectrograms as cli
    from configurable_spectrograms_torch.utils.logging import flush_log_buffer, set_logfile_path

    class _Cfg:
        def __init__(self, **kw):
            pass

        def run(self):
            raise KeyboardInterrupt

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "FastBatchConfig", _Cfg)
    try:
        with pytest.raises(KeyboardInterrupt):
            cli.main()
    finally:
        flush_log_buffer()
        set_logfile_path(None)


@pytest.mark.parametrize("which", ["batch_multi_plot_spectrogram", "batch_multi_plot_FAST_spectrograms"])
def test_reexports_match_the_root_scripts_and_resolve_to_the_port(which):
    """The shim's and the flagship CLI's ``__all__`` equal the root scripts'; every name is the port's object."""
    root = importlib.import_module(which)
    mod = importlib.import_module({
        "batch_multi_plot_spectrogram": "configurable_spectrograms_torch.batch_multi_plot_spectrogram",
        "batch_multi_plot_FAST_spectrograms": "configurable_spectrograms_torch.cli.batch_multi_plot_FAST_spectrograms",
    }[which])
    from configurable_spectrograms_torch import constants
    from configurable_spectrograms_torch.fast import constants as fast_constants

    assert mod.__all__ == root.__all__
    for name in mod.__all__:
        obj = getattr(mod, name)
        if callable(obj):
            assert obj.__module__.startswith("configurable_spectrograms_torch."), name
            assert obj is not getattr(root, name), name
        else:
            assert obj is getattr(constants, name, None) or obj is getattr(fast_constants, name, None), name
            assert obj == getattr(root, name), name


@pytest.mark.parametrize(
    "cli_name,argv",
    [
        ("single_day_FAST_CDF_download", ["--date", "2020-01-01"]),
        ("single_day_FAST_CDF_download", ["--date", "1996-08-20"]),
        ("single_day_FAST_CDF_download", ["--date", "2000-13-01"]),
        ("single_day_FAST_CDF_download", []),
        ("single_day_FAST_CDF_download", ["--date", "2000-01-01", "--instruments", "esv"]),
        ("FAST_CDF_download", ["--year", "2050"]),
        ("FAST_CDF_download", ["--year", "1995"]),
        ("FAST_CDF_download", ["--year", "abc"]),
        ("FAST_CDF_download", ["--instruments", "xyz"]),
    ],
)
def test_download_cli_validation_exits_2_before_the_network(cli_name, argv, host_backends, tmp_path, monkeypatch):
    jcli = importlib.import_module(cli_name)
    cli = importlib.import_module(f"configurable_spectrograms_torch.cli.{cli_name}")
    for main in (cli.main, jcli.main):
        assert _run_main(monkeypatch, main, [*argv, "--output_path", str(tmp_path)]) == 2


@pytest.mark.parametrize("found,code", [({"ees": ["a.cdf", "b.cdf"], "ies": []}, 0), ({"ees": [], "ies": []}, 1)])
def test_day_download_cli_reports_counts(found, code, host_backends, tmp_path, monkeypatch, capsys):
    import single_day_FAST_CDF_download as jcli
    from configurable_spectrograms_tpu.data import download as jdl

    from configurable_spectrograms_torch.cli import single_day_FAST_CDF_download as cli
    from configurable_spectrograms_torch.data import download as dl

    calls = []
    for mod in (dl, jdl):
        monkeypatch.setattr(mod, "download_single_day_cdf", lambda **kw: calls.append(kw) or found)
    outs = []
    for main in (cli.main, jcli.main):
        argv = ["--date", "2000-01-01", "--instruments", "ees", "ies", "--output_path", str(tmp_path)]
        assert _run_main(monkeypatch, main, argv) == code
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and calls[0] == calls[1]
    assert calls[0]["instruments"] == ["ees", "ies"] and calls[0]["data_folder"] == str(tmp_path)


def test_year_download_cli_forwards_its_flags(host_backends, tmp_path, monkeypatch):
    import FAST_CDF_download as jcli
    from configurable_spectrograms_tpu.data import download as jdl

    from configurable_spectrograms_torch.cli import FAST_CDF_download as cli
    from configurable_spectrograms_torch.data import download as dl

    calls = []
    for mod in (dl, jdl):
        monkeypatch.setattr(mod, "FAST_ESA_CDF_download", lambda **kw: calls.append(kw))
    for main in (cli.main, jcli.main):
        assert _run_main(monkeypatch, main, ["--year", "2001", "--instruments", "ieb", "--output_path",
                                             str(tmp_path), "--base_url", "http://localhost/x"]) == 0
    assert calls[0] == calls[1] == {"base_url": "http://localhost/x", "year": 2001, "data_folder": str(tmp_path),
                                    "instruments": ["ieb"]}


def test_download_functions_match_the_jax_package_offline(host_backends, tmp_path, monkeypatch):
    """Listings and fetches replaced: the day download keeps files on disk, the year loop and the threaded batch."""
    import datetime as dt

    from configurable_spectrograms_tpu.data import download as jdl

    from configurable_spectrograms_torch.data import download as dl

    listing = ["fa_esa_l2_ees_20000101001737_13312_v02.cdf", "fa_esa_l2_ees_20000102001737_13313_v02.cdf",
               "fa_esa_l2_ies_20000101001737_13312_v02.cdf", "index.html"]
    out = {}
    for name, mod in (("port", dl), ("jax", jdl)):
        fetched = []
        monkeypatch.setattr(mod, "_list_instrument_page_files", lambda page: list(listing))
        monkeypatch.setattr(mod, "_download_single_cdf_file",
                            lambda link, path, fetched=fetched: fetched.append(link) or Path(path).write_bytes(b"x"))
        folder = str(tmp_path / name)
        day = mod.download_single_day_cdf(dt.date(2000, 1, 1), instruments=["ees", "ies"], data_folder=folder)
        again = mod.download_single_day_cdf(dt.date(2000, 1, 1), instruments=["ees"], data_folder=folder)
        mod.FAST_ESA_CDF_download(year=2000, data_folder=folder, instruments=["ies"])
        batch = mod.download_cdf_files_threaded(years=[2001], data_folder=folder, instruments={"ees"}, max_workers=2,
                                                progress_json_path=str(tmp_path / f"{name}.json"))
        out[name] = {
            "day": {k: [os.path.relpath(p, folder) for p in v] for k, v in day.items()},
            "again": {k: [os.path.relpath(p, folder) for p in v] for k, v in again.items()},
            "fetched": sorted(fetched),
            "batch": sorted((link, os.path.relpath(p, folder), st) for (link, p), st in batch),
        }
    assert out["port"] == out["jax"]
    assert out["port"]["day"] == {"ees": ["2000/01/fa_esa_l2_ees_20000101001737_13312_v02.cdf"],
                                  "ies": ["2000/01/fa_esa_l2_ies_20000101001737_13312_v02.cdf"]}


@pytest.mark.parametrize("which", ["single_plot_FAST_spectrograms", "single_day_FAST_CDF_download"])
def test_clis_run_as_modules_on_the_cpu(which, archive, tmp_path):
    """``CST_TORCH_DEVICE=cpu python -m configurable_spectrograms_torch.cli.<name> ...``."""
    env = dict(os.environ, CST_TORCH_DEVICE="cpu", CST_RENDER_BACKEND="device", OMP_NUM_THREADS="1",
               CST_CUSP_CSV=archive["cusp"], PYTHONPATH=f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    out = tmp_path / "m.png"
    argv, code = {
        "single_plot_FAST_spectrograms": (["--cdf-file", archive["files"]["ees"], "--output", str(out)], 0),
        "single_day_FAST_CDF_download": (["--date", "2020-01-01"], 2),
    }[which]
    proc = subprocess.run([sys.executable, "-m", f"configurable_spectrograms_torch.cli.{which}", *argv],
                          capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == code, proc.stderr[-3000:]
    assert out.exists() == (code == 0)
    if code == 0:
        assert f"[SAVED] {out}" in proc.stdout
    else:
        assert "outside FAST ESA CDF coverage" in proc.stderr
