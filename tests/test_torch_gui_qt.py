"""The port's Qt front-end against the JAX package's, on the headless stand-ins, on the CPU.

Each package's ``run_qt()`` runs on its own copy of the headless PySide6
stand-in (both register themselves as ``PySide6``, so each is installed
around its own run) and is driven with the same clicks and field values.
Every page's action starts a child process that runs a module-level
recording target: the two front-ends must make the same target call, show
the same status text and leave the same entry, slider and chip values.
The JAX front-end's children are spawned too (its ``multiprocessing`` is
swapped for the spawn context here), so no test forks a process that has
started JAX.

Then the port's own behaviour, as ``tests/test_gui_qt.py`` checks the JAX
front-end's: navigation and theme, progress streamed into the label, Stop
of a hanging child, ``main()`` routing, and the spawn ``ActionRunner``.
This module imports neither JAX nor torch at import time: the spawned
children import it to find their targets.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import sys
import time

import pytest
from test_gui_qt import _button, _chips_by_text, _edits_by_name, _page_labels, _wait_for

# -- spawn-safe process targets (module-level, picklable) ---------------------


def _record_target(*args, **kwargs) -> None:
    with open(os.environ["CST_TEST_MARKER"], "w") as f:
        json.dump({"args": repr(args), "kwargs": repr(sorted(kwargs.items()))}, f)


def _progress_writer_target(*args, **kwargs) -> None:
    with open(os.environ["CST_TEST_PROGRESS"], "w") as f:
        json.dump({"log_log_last_orbit": 4100, "errors": []}, f)
    time.sleep(2.5)  # outlive one ProgressTail poll interval


def _hang_target(*args, **kwargs) -> None:
    time.sleep(600)


def _child_ok() -> None:
    pass


def _child_fail() -> None:
    raise SystemExit(3)


# -- driving a front-end ------------------------------------------------------


@contextlib.contextmanager
def front_end(pkg: str, monkeypatch):
    """(front-end module, its stand-in) with the stand-in installed as PySide6 for the block."""
    if pkg == "jax":
        import GUI_batch_download_plot_FAST as mod
        from configurable_spectrograms_tpu.fast import constants
        from configurable_spectrograms_tpu.gui import headless_qt

        # The JAX ActionRunner starts the platform default (fork); spawn its children like the port's.
        monkeypatch.setattr(mod, "multiprocessing", multiprocessing.get_context("spawn"))
    else:
        from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as mod
        from configurable_spectrograms_torch.fast import constants
        from configurable_spectrograms_torch.gui import headless_qt
    assert headless_qt.install(force=True)
    try:
        yield mod, headless_qt, constants
    finally:
        headless_qt.QApplication.exec_hook = None
        headless_qt.QApplication._instance = None
        headless_qt.uninstall()


def drive(mod, qt, hook) -> None:
    """Run ``mod.run_qt()`` with *hook* driving the UI; re-raise what the hook raised."""
    errors: list[BaseException] = []

    def wrapped(app):
        try:
            hook(app)
        except BaseException as exc:  # surfaced after exec returns
            errors.append(exc)
        finally:
            app.quit()

    qt.QApplication.exec_hook = wrapped
    try:
        assert mod.run_qt() == 0
    finally:
        qt.QApplication.exec_hook = None
    if errors:
        raise errors[0]


def _stack(app, qt):
    return app.topLevelWidgets()[0].findChildren(qt.QStackedWidget)[0]


def _no_live_children() -> bool:
    return not any(p.is_alive() for p in multiprocessing.active_children())


# -- the port against the JAX front-end, page by page -------------------------

#: case -> (page index, the page's target, run button, chip clicks, {field: typed text}).
#: ``{tmp}`` in a value is the test's temporary directory.
PAGE_CASES = {
    "download-chips": (0, "download_in_process", "Download", ["ieb", "2000", "2001", "1996"],
                       {"Data folder": "{tmp}/dl"}),
    "download-default": (0, "download_in_process", "Download", [], {}),
    "download-no-year": (0, "download_in_process", "Download", ["2000"], {}),
    "download-no-instrument": (0, "download_in_process", "Download", ["ees", "eeb", "ies", "ieb"], {}),
    "plot": (1, "plot_in_process", "Plot", [],
             {"Data folder": "{tmp}/data", "Output folder": "{tmp}/plots", "Percentile": "99.5",
              "Scale combos": "log-log linear-log-turbo", "Cusp style": "line"}),
    "plot-defaults": (1, "plot_in_process", "Plot", [], {}),
    "plot-percentile-clamped": (1, "plot_in_process", "Plot", [], {"Percentile": "250"}),
    "plot-percentile-junk": (1, "plot_in_process", "Plot", [], {"Percentile": "not-a-number"}),
    "plot-bad-combo": (1, "plot_in_process", "Plot", [], {"Scale combos": "sqrt-log"}),
    "single-day": (2, "single_in_process", "Render", [],
                   {"Data folder": "{tmp}/data", "Orbit": "123", "Output PNG": "{tmp}/out.png",
                    "Style y-z[-cmap]": "log-log", "Cusp style": "bracket"}),
    "single-day-bad-orbit": (2, "single_in_process", "Render", [], {"Orbit": "12x"}),
    "single-day-two-combos": (2, "single_in_process", "Render", [], {"Style y-z[-cmap]": "log-log linear-linear"}),
    "single-day-bad-combo": (2, "single_in_process", "Render", [], {"Style y-z[-cmap]": "log-cubic"}),
    "from-files": (3, "single_in_process", "Render from files", [],
                   {"ees file": "{tmp}/ees.cdf", "ies file": "{tmp}/ies.cdf", "Output PNG": "{tmp}/files.png",
                    "Style y-z[-cmap]": "linear-log-turbo"}),
    "from-no-files": (3, "single_in_process", "Render from files", [], {}),
    "pitch-angle": (4, "single_in_process", "Render pitch-angle grid", [],
                    {"CDF file": "{tmp}/ees.cdf", "Output PNG": "{tmp}/pitch.png", "Cusp style": "line"}),
    "by-date": (5, "single_in_process", "Download + render", [],
                {"Date": "2001-02-03", "Download folder": "{tmp}/dl", "Output PNG": "{tmp}/day.png",
                 "Style y-z[-cmap]": "log-linear"}),
}


def run_page_case(pkg: str, case: str, tmp_path, monkeypatch) -> dict:
    """Drive one page of *pkg*'s front-end through *case*; what it showed and the call its child recorded."""
    index, target, run_label, clicks, fields = PAGE_CASES[case]
    marker = tmp_path / f"{pkg}_call.json"
    monkeypatch.setenv("CST_TEST_MARKER", str(marker))
    seen: dict = {}
    with front_end(pkg, monkeypatch) as (mod, qt, constants):
        monkeypatch.setattr(mod, target, _record_target)
        monkeypatch.setattr(constants, "FAST_PLOTTING_PROGRESS_JSON", str(tmp_path / "no_progress.json"))

        def hook(app):
            page = _stack(app, qt).widget(index)
            chips = _chips_by_text(page, qt)
            for text in clicks:
                chips[text].click()
            edits = _edits_by_name(page, qt)
            for name, value in fields.items():
                edits[name].type_text(value.format(tmp=tmp_path))
            status, progress = _page_labels(page, qt)
            _button(page, qt, run_label).click()
            _wait_for(app, lambda: status.text() not in ("", "Running..."), what=f"{pkg} {case} to end")
            _wait_for(app, _no_live_children, what=f"{pkg} {case}: the child to exit")
            seen.update(
                status=status.text(), progress=progress.text(),
                fields={name: e.text() for name, e in edits.items()},
                sliders=[s.value() for s in page.findChildren(qt.QSlider)],
                notes=[w.text() for w in page.findChildren(qt.QLabel) if w.objectName() == "noteText"],
                chips={text: c.isChecked() for text, c in chips.items()},
                chip_props={text: c.property("selected") for text, c in chips.items()},
            )

        drive(mod, qt, hook)
    seen["call"] = json.loads(marker.read_text()) if marker.exists() else None
    return seen


@pytest.mark.parametrize("case", list(PAGE_CASES))
def test_each_page_makes_the_jax_front_ends_target_call(case, tmp_path, monkeypatch):
    port = run_page_case("torch", case, tmp_path, monkeypatch)
    jax = run_page_case("jax", case, tmp_path, monkeypatch)
    assert port == jax
    invalid = case.endswith(("no-year", "no-instrument", "bad-combo", "bad-orbit", "two-combos"))
    if invalid:
        assert port["status"].startswith("Invalid input:") and port["call"] is None
    else:
        assert port["status"] == "Finished." and port["call"] is not None


def test_the_recorded_calls_carry_the_page_values(tmp_path, monkeypatch):
    """Spot checks of what the parity cases compare: the years and instruments, the float percentile, the style."""
    dl = run_page_case("torch", "download-chips", tmp_path, monkeypatch)["call"]
    assert dl["args"] == repr(([1996, 2001], ["ees", "eeb", "ies"], f"{tmp_path}/dl"))
    plot = run_page_case("torch", "plot", tmp_path, monkeypatch)
    assert plot["call"]["args"] == repr((f"{tmp_path}/data", f"{tmp_path}/plots",
                                         [("log", "log", "inferno"), ("linear", "log", "turbo")], 99.5, "line", False))
    assert plot["sliders"] == [100] and plot["fields"]["Percentile"] == "99.5"
    single = run_page_case("torch", "single-day", tmp_path, monkeypatch)["call"]
    assert single["args"] == repr(("instrument-grid", f"{tmp_path}/out.png"))
    assert single["kwargs"] == repr(sorted(dict(data_folder=f"{tmp_path}/data", orbit=123, y_scale="log",
                                                z_scale="log", colormap="inferno",
                                                cusp_marker_style="bracket").items()))


# -- the port's own behaviour ---------------------------------------------------


def test_run_qt_navigation_and_theme(monkeypatch):
    monkeypatch.setenv("CST_GUI_THEME", "dark")
    with front_end("torch", monkeypatch) as (mod, qt, _):

        def hook(app):
            win = app.topLevelWidgets()[0]
            assert win.windowTitle() == "FAST spectrograms"
            stack = _stack(app, qt)
            navs = [b for b in win.findChildren(qt.QPushButton) if b.objectName() == "navBtn"]
            assert stack.count() == 6 and len(navs) == 6
            assert navs[0].property("selected") == "true"
            navs[1].click()
            assert stack.currentIndex() == 1
            assert navs[1].property("selected") == "true" and navs[0].property("selected") == "false"
            navs[5].click()
            assert stack.currentIndex() == 5
            sheet = app.styleSheet()
            assert "#1e1f22" in sheet  # the dark background token
            assert 'QPushButton#navBtn[selected="true"]' in sheet
            assert 'QPushButton#chip[selected="true"]' in sheet

        drive(mod, qt, hook)


@pytest.mark.parametrize("theme,token", [("light", "#f7f7f7"), ("none", None)])
def test_run_qt_light_and_no_theme(theme, token, monkeypatch):
    monkeypatch.setenv("CST_GUI_THEME", theme)
    with front_end("torch", monkeypatch) as (mod, qt, _):
        seen = {}
        drive(mod, qt, lambda app: seen.update(sheet=app.styleSheet()))
    assert (token in seen["sheet"]) if token else seen["sheet"] == ""


def test_plot_page_percentile_slider_linked(monkeypatch):
    """The percentile slider and its entry stay in sync both ways and the note tracks the value."""
    with front_end("torch", monkeypatch) as (mod, qt, _):

        def hook(app):
            page = _stack(app, qt).widget(1)
            (slider,) = page.findChildren(qt.QSlider)
            assert (slider.minimum(), slider.maximum()) == (0, 100)
            entry = _edits_by_name(page, qt)["Percentile"]
            assert slider.value() == 90 and entry.text() == "90.0"
            note = next(w for w in page.findChildren(qt.QLabel) if w.objectName() == "noteText")
            assert "Current value: 90.0" in note.text()
            slider.setValue(95)
            assert entry.text() == "95" and "Current value: 95.0" in note.text()
            entry.type_text("80")
            assert slider.value() == 80
            entry.type_text("99.5")
            assert slider.value() == 100 and entry.text() == "99.5" and "Current value: 99.5" in note.text()
            entry.type_text("250")
            assert slider.value() == 100 and entry.text() == "100.0"
            entry.type_text("not-a-number")
            assert slider.value() == 100 and entry.text() == "100.0"

        drive(mod, qt, hook)


def test_plot_page_streams_progress_then_stops_a_hanging_child(tmp_path, monkeypatch):
    progress = tmp_path / "progress.json"
    monkeypatch.setenv("CST_TEST_PROGRESS", str(progress))
    with front_end("torch", monkeypatch) as (mod, qt, constants):
        monkeypatch.setattr(constants, "FAST_PLOTTING_PROGRESS_JSON", str(progress))
        monkeypatch.setattr(mod, "plot_in_process", _progress_writer_target)

        def hook(app):
            page = _stack(app, qt).widget(1)
            edits = _edits_by_name(page, qt)
            edits["Data folder"].setText(str(tmp_path))
            edits["Scale combos"].setText("log-log")
            status, progress_label = _page_labels(page, qt)
            _button(page, qt, "Plot").click()
            assert status.text() == "Running..."
            # ProgressTail polls the progress JSON (1 s) and streams its summary through the queued bridge.
            _wait_for(app, lambda: progress_label.text() == "log_log @ orbit 4100", what="progress label")
            _wait_for(app, lambda: status.text() == "Finished.", what="plot finish")

            monkeypatch.setattr(mod, "plot_in_process", _hang_target)
            _button(page, qt, "Plot").click()
            assert status.text() == "Running..."
            _wait_for(app, lambda: any(p.is_alive() for p in multiprocessing.active_children()),
                      what="hung child alive")
            t0 = time.monotonic()
            _button(page, qt, "Stop").click()
            assert time.monotonic() - t0 < 10
            assert status.text() == "Stopped."
            _wait_for(app, _no_live_children, timeout=10, what="hung child killed")
            # Nothing reports after a stop: the status stays "Stopped.".
            time.sleep(0.3)
            app.processEvents()
            assert status.text() == "Stopped."

        drive(mod, qt, hook)


@pytest.mark.parametrize("route", ["headless-env", "no-qt", "tui-flag"])
def test_main_routes_like_the_jax_front_end(route, monkeypatch, capsys):
    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as mod
    from configurable_spectrograms_torch.gui import headless_qt

    monkeypatch.setattr(sys, "argv", ["prog", *(["--tui"] if route == "tui-flag" else [])])
    monkeypatch.setattr(mod, "run_tui", lambda: 7)
    if route != "headless-env":
        monkeypatch.delenv("CST_GUI_HEADLESS_QT", raising=False)
        assert mod.main() == 7
        info = "[INFO] PySide6 not installed; using the terminal front-end."
        assert (info in capsys.readouterr().out) == (route == "no-qt")
        return
    monkeypatch.setenv("CST_GUI_HEADLESS_QT", "1")
    seen = {}

    def hook(app):
        seen["pages"] = _stack(app, headless_qt).count()
        app.quit()

    headless_qt.QApplication.exec_hook = hook
    try:
        assert mod.main() == 0
    finally:
        headless_qt.QApplication.exec_hook = None
        headless_qt.QApplication._instance = None
        headless_qt.uninstall()
    assert seen["pages"] == 6


@pytest.mark.parametrize("target,code", [(_child_ok, 0), (_child_fail, 3)])
def test_action_runner_spawns_and_reports_the_exit_code(target, code):
    import threading

    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as mod

    done = threading.Event()
    seen = []
    runner = mod.ActionRunner(target, (), on_finished=lambda: (seen.append("finished"), done.set()),
                              on_error=lambda c: (seen.append(c), done.set()))
    runner.start()
    assert isinstance(runner._proc, multiprocessing.get_context("spawn").Process)
    assert done.wait(60)
    assert runner.wait() == code and not runner._proc.is_alive()
    assert seen == (["finished"] if code == 0 else [code])


def test_action_runner_exit_code_survives_concurrent_reapers():
    """wait(), the monitor thread and active_children() all collect one child: each sees its exit code.

    The JAX front-end's ``ActionRunner`` joins from two threads; the thread
    that loses the reap gets ``None`` (wait() returns None, the monitor
    reports ``on_error(None)``).  Eight children at once, a short switch
    interval, and the main thread reaping through active_children().
    """
    import threading

    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as mod

    codes, reported = [], []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runners = [mod.ActionRunner(_child_ok, (), on_finished=lambda: reported.append(0),
                                    on_error=reported.append) for _ in range(8)]
        for r in runners:
            r.start()
        waiters = [threading.Thread(target=lambda r=r: codes.append(r.wait()), daemon=True) for r in runners]
        for w in waiters:
            w.start()
        deadline = time.monotonic() + 120
        while any(w.is_alive() for w in waiters) and time.monotonic() < deadline:
            multiprocessing.active_children()
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in waiters)
    assert _wait_until(lambda: len(reported) == 8)
    assert codes == [0] * 8 and reported == [0] * 8


def _wait_until(predicate, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def test_action_runner_stop_kills_the_child_and_reports_nothing():
    import threading

    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as mod

    called = threading.Event()
    runner = mod.ActionRunner(_hang_target, (), on_finished=called.set, on_error=lambda c: called.set())
    runner.start()
    deadline = time.monotonic() + 30
    while not runner._proc.is_alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    runner.stop()
    assert not runner._proc.is_alive() and runner._proc.exitcode != 0
    assert not called.wait(0.5)
    assert mod.ActionRunner(_child_ok).wait() is None  # never started
