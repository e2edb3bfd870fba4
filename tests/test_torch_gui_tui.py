"""The port's terminal front-end and its process targets, on the CPU.

The ``--tui`` menu runs as ``python -m
configurable_spectrograms_torch.cli.GUI_batch_download_plot_FAST --tui``
in a subprocess with JAX blocked: a directory at the front of
``PYTHONPATH`` holds ``jax``, ``jaxlib`` and ``configurable_spectrograms_tpu``
packages and a module for each root script, all of which raise on import.
The menu's spawned child inherits the path, so a flow that ends ``Done.``
ran through the port alone.  Then the three process targets against the
JAX root front-end's: the single-day figure decodes to the same pixels on
the host backend in every mode, and the download and plot targets make the
same calls into their packages.  And the module's doctests,
``parse_scale_combos`` and ``ProgressTail``, as tests/test_batch_layer.py
checks the JAX front-end's.
"""

from __future__ import annotations

import doctest
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
ORBIT = 4400
MODULE = "configurable_spectrograms_torch.cli.GUI_batch_download_plot_FAST"


@pytest.fixture(scope="module")
def archive(tmp_path_factory) -> dict:
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("gui_tui")
    mapping = synth_fast_archive(str(root / "data"), [ORBIT], n_time=64, n_angle=8, n_energy=16,
                                 cusp_csv_path=str(root / "cusp.tsv"), seed=17)
    return {"root": root, "data": str(root / "data"), "cusp": str(root / "cusp.tsv"), "files": mapping[ORBIT]}


@pytest.fixture(scope="module")
def blocked_env(archive, tmp_path_factory) -> dict:
    """The environment of a TUI run that cannot import JAX, the JAX package or a root script."""
    block = tmp_path_factory.mktemp("block")
    for name in ("jax", "jaxlib", "configurable_spectrograms_tpu"):
        (block / name).mkdir()
        (block / name / "__init__.py").write_text(f"raise ImportError('{name} is blocked')\n")
    for script in REPO.glob("*.py"):
        (block / script.name).write_text(f"raise ImportError('the root script {script.stem} is blocked')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("CST_", "JAX_"))}
    env.update(PYTHONPATH=f"{block}{os.pathsep}{REPO}", CST_TORCH_DEVICE="cpu", CST_CUSP_CSV=archive["cusp"],
               OMP_NUM_THREADS="1")
    return env


def test_the_block_reaches_a_spawned_child(blocked_env, tmp_path):
    probe = (
        "import multiprocessing as mp, importlib\n"
        "if __name__ == '__main__':\n"
        "    for name in ('jax', 'configurable_spectrograms_tpu', 'single_plot_FAST_spectrograms'):\n"
        "        p = mp.get_context('spawn').Process(target=importlib.import_module, args=(name,))\n"
        "        p.start(); p.join(60)\n"
        "        print(name, p.exitcode)\n"
    )
    script = tmp_path / "probe.py"
    script.write_text(probe)
    proc = subprocess.run([sys.executable, str(script)], env=blocked_env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["jax", "1", "configurable_spectrograms_tpu", "1",
                                   "single_plot_FAST_spectrograms", "1"]


#: case -> (menu answers, the PNG it writes or None, text the output must hold).
TUI_CASES = {
    "instrument-grid": ("3\ninstrument-grid\nout.png\nlog-log\n\n{data}\n{orbit}\nq\n", "out.png", "Done."),
    "files": ("3\nfiles\nout_files.png\nlog-log\nline\n{ees}\n{eeb}\n\n\nq\n", "out_files.png", "Done."),
    "pitch-angle": ("3\npitch-angle\npitch.png\n\nbracket\n{ies}\nq\n", "pitch.png", "Done."),
    "missing-orbit": ("3\ninstrument-grid\nnone.png\n\n\n{data}\n1\nq\n", None, "Exited with code 1."),
    "plot": ("2\n{data}\nplots\n\nlog-log\n\nq\n", None, "Done."),
    "bad-combo": ("2\n{data}\nplots\n\nsqrt-log\nq\n", None, "bad scale combo 'sqrt-log'"),
    "two-styles": ("3\ninstrument-grid\nout.png\nlog-log linear-linear\nq\n", None, "too many values to unpack"),
    "unknown-choice": ("x\nq\n", None, "Unknown choice."),
}


def _tui(answers: str, env: dict, cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", MODULE, "--tui"], input=answers, text=True, cwd=cwd, env=env,
                          capture_output=True, timeout=240)


@pytest.mark.parametrize("case", list(TUI_CASES))
def test_tui_flow_with_jax_blocked(case, archive, blocked_env, tmp_path):
    answers, png, expect = TUI_CASES[case]
    files = archive["files"]
    answers = answers.format(data=archive["data"], orbit=ORBIT, ees=files["ees"], eeb=files["eeb"], ies=files["ies"])
    proc = _tui(answers, blocked_env, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert expect in proc.stdout, proc.stdout + proc.stderr
    assert "blocked" not in proc.stderr, proc.stderr
    if png is not None:
        from PIL import Image

        with Image.open(tmp_path / png) as im:
            assert im.size[0] > 0 and im.size[1] > 0
    if case == "plot":
        written = sorted(p.relative_to(tmp_path / "plots").as_posix() for p in (tmp_path / "plots").rglob("*.png"))
        # One orbit, raw and given extrema: 4 instruments' pitch grids each, and the two instrument grids.
        assert len(written) == 10 and all("_y-log_z-log_" in p for p in written), written
        assert (tmp_path / "batch_multi_plot_FAST_progress.json").exists()
    else:
        assert not (tmp_path / "plots").exists()
    if case == "missing-orbit":
        assert not (tmp_path / "none.png").exists()


def test_tui_instrument_grid_is_the_single_targets_figure(archive, blocked_env, tmp_path, monkeypatch):
    """The TUI's child draws what the port's single_in_process draws in this process."""
    from test_torch_slice import _assert_same_pixels

    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui
    from configurable_spectrograms_torch.data import cdf_utils

    proc = _tui(TUI_CASES["instrument-grid"][0].format(data=archive["data"], orbit=ORBIT), blocked_env, tmp_path)
    assert proc.returncode == 0 and "Done." in proc.stdout, proc.stdout + proc.stderr
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_CUSP_CSV", archive["cusp"])
    monkeypatch.delenv("CST_RENDER_BACKEND", raising=False)
    monkeypatch.setattr(cdf_utils, "filtered_orbits_cache", {})
    here = tmp_path / "here.png"
    gui.single_in_process("instrument-grid", str(here), data_folder=archive["data"], orbit=ORBIT,
                          y_scale="log", z_scale="log", colormap="inferno")
    _assert_same_pixels((tmp_path / "out.png").read_bytes(), here.read_bytes(), "instrument-grid")


# -- the process targets against the JAX root front-end's -------------------------


@pytest.fixture
def both_on_host(archive, monkeypatch):
    """Both packages on their host backends, the archive's cusp table, the day download faked."""
    from configurable_spectrograms_tpu.data import cdf_utils as jcdf
    from configurable_spectrograms_tpu.data import download as jdl
    from configurable_spectrograms_tpu.render import figure as jfigure

    from configurable_spectrograms_torch.data import cdf_utils
    from configurable_spectrograms_torch.data import download as dl

    monkeypatch.setitem(jfigure._BACKEND, "mode", "host")
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_CUSP_CSV", archive["cusp"])
    calls = []

    def day(date, instruments, data_folder):
        calls.append((date.isoformat(), tuple(instruments), data_folder))
        return {inst: [archive["files"][inst]] for inst in instruments}

    for mod in (cdf_utils, jcdf):
        monkeypatch.setattr(mod, "filtered_orbits_cache", {})
    for mod in (dl, jdl):
        monkeypatch.setattr(mod, "download_single_day_cdf", day)
    return calls


def _single_kwargs(mode: str, archive: dict, tmp_path: Path) -> dict:
    files = archive["files"]
    return {
        "instrument-grid": dict(data_folder=archive["data"], orbit=ORBIT, y_scale="log", z_scale="log",
                                colormap="inferno"),
        "files": dict(instrument_files={"ies": files["ies"], "ees": files["ees"]}, z_scale="log",
                      cusp_marker_style="line"),
        "pitch-angle": dict(cdf_file=files["eeb"], y_scale="log", colormap="turbo", cusp_marker_style="bracket"),
        "date": dict(date="2000-06-01", data_folder=str(tmp_path / "dl"), z_scale="log"),
    }[mode]


@pytest.mark.parametrize("mode", ["instrument-grid", "files", "pitch-angle", "date"])
def test_single_in_process_draws_the_jax_front_ends_figure(mode, archive, both_on_host, tmp_path):
    import GUI_batch_download_plot_FAST as jgui
    from test_torch_slice import _assert_same_pixels

    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui

    kwargs = _single_kwargs(mode, archive, tmp_path)
    gui.single_in_process(mode, str(tmp_path / "port.png"), **kwargs)
    jgui.single_in_process(mode, str(tmp_path / "jax.png"), **kwargs)
    _assert_same_pixels((tmp_path / "port.png").read_bytes(), (tmp_path / "jax.png").read_bytes(), mode)
    if mode == "date":
        want = ("2000-06-01", ("ees", "eeb", "ies", "ieb"), str(tmp_path / "dl"))
        assert both_on_host == [want, want]


@pytest.mark.parametrize("mode,kwargs", [
    ("instrument-grid", {"data_folder": "{data}", "orbit": 1}),
    ("files", {"instrument_files": {}}),
    ("files", {}),
])
def test_single_in_process_exits_1_when_nothing_is_drawn(mode, kwargs, archive, both_on_host, tmp_path):
    import GUI_batch_download_plot_FAST as jgui

    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui

    kwargs = {k: (v.format(data=archive["data"]) if isinstance(v, str) else v) for k, v in kwargs.items()}
    for mod in (gui, jgui):
        with pytest.raises(SystemExit) as exc:
            mod.single_in_process(mode, str(tmp_path / "none.png"), **kwargs)
        assert exc.value.code == 1
    assert not (tmp_path / "none.png").exists()


def test_plot_and_download_targets_make_the_jax_front_ends_calls(monkeypatch):
    import GUI_batch_download_plot_FAST as jgui
    from configurable_spectrograms_tpu.data import download as jdl
    from configurable_spectrograms_tpu.fast import batch_directory as jbatch

    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui
    from configurable_spectrograms_torch.data import download as dl
    from configurable_spectrograms_torch.fast import batch_directory as batch

    calls: dict[str, list] = {"torch": [], "jax": []}
    for name, dmod, bmod in (("torch", dl, batch), ("jax", jdl, jbatch)):
        monkeypatch.setattr(dmod, "download_cdf_files_threaded",
                            lambda *a, _n=name, **k: calls[_n].append(("download", a, k)))
        monkeypatch.setattr(bmod, "FAST_plot_spectrograms_directory",
                            lambda *a, _n=name, **k: calls[_n].append(("plot", a, k)))
    combos = [("log", "log", "inferno"), ("linear", "log", "turbo")]
    for mod in (gui, jgui):
        mod.download_in_process([1999, 2000], ["ees", "ieb"], "dl")
        mod.plot_in_process("data", "plots", combos, 99.0, "line", False)
        mod.plot_in_process("data", "plots", combos[:1], None, "both", True)
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][0] == ("download", (), {"years": [1999, 2000], "instruments": {"ees", "ieb"},
                                                  "data_folder": "dl"})
    plots = [k for what, _, k in calls["torch"] if what == "plot"]
    assert [(k["y_scale"], k["z_scale"], k["colormap"]) for k in plots] == combos + combos[:1]
    assert all(k["use_tqdm"] is True for k in plots)
    assert [k["override_plots"] for k in plots] == [False, False, True]


# -- module helpers, as tests/test_batch_layer.py checks the JAX front-end's ------------


def test_module_doctests():
    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui

    result = doctest.testmod(gui)
    assert result.attempted >= 2 and result.failed == 0


def test_parse_scale_combos():
    import GUI_batch_download_plot_FAST as jgui

    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui

    parse = gui.parse_scale_combos
    assert gui.DEFAULT_SCALE_COMBOS == jgui.DEFAULT_SCALE_COMBOS
    assert parse("all") == gui.DEFAULT_SCALE_COMBOS and parse("  ") == gui.DEFAULT_SCALE_COMBOS
    assert parse("log-log") == [("log", "log", "inferno")]
    assert parse("linear-log-turbo log-linear") == [("linear", "log", "turbo"), ("log", "linear", "plasma")]
    for bad in ("sqrt-log", "linear", "linear-log-", "log-cubic"):
        with pytest.raises(ValueError) as port_exc:
            parse(bad)
        with pytest.raises(ValueError) as jax_exc:
            jgui.parse_scale_combos(bad)
        assert str(port_exc.value) == str(jax_exc.value)


def _wait_until(predicate, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def test_progress_tail_streams_updates_and_reads_once_more_on_stop(tmp_path):
    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui

    path = tmp_path / "prog.json"
    seen: list[str] = []
    tail = gui.ProgressTail(str(path), seen.append, interval=0.05).start()
    time.sleep(0.15)  # no file yet -> no callbacks
    assert seen == []
    path.write_text(json.dumps({"log_log_last_orbit": 4100, "log_log_error_plotting": []}))
    assert _wait_until(lambda: "log_log @ orbit 4100" in seen), seen
    path.write_text("{not json")  # mid-write: skipped
    path.write_text(json.dumps({"log_log_last_orbit": 4101, "completed_items": ["a", "b"], "errors": ["x"]}))
    assert _wait_until(lambda: "log_log @ orbit 4101; 2 completed; 1 errors" in seen), seen
    assert len(seen) == len(set(seen))  # an unchanged summary is not repeated
    slow = gui.ProgressTail(str(path), seen.append, interval=3600).start()
    path.write_text(json.dumps({"linear_log_last_orbit": 7}))
    slow.stop()  # the final read still reports the last write
    tail.stop()
    assert _wait_until(lambda: "linear_log @ orbit 7" in seen), seen
