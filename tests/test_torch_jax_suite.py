"""The JAX package's own test suite, run against the port.

Every ``tests/test_*.py`` of the JAX package (not the ``test_torch_*``
files) runs in one child ``python -m pytest`` over a staged tree in which
the JAX package does not exist:

* copies of the JAX test files and of what they read (``tests/goldens``,
  ``tests/oracle.py``, ``FAST_Cusp_Indices.csv``, ``docs``, ``tools``,
  ``pre_commit_hooks``), so ``Path(__file__).resolve().parent.parent`` is
  the staged root, never the checkout;
* a package named ``configurable_spectrograms_tpu`` whose every module
  ``configurable_spectrograms_tpu.X`` *is* the module object
  ``configurable_spectrograms_torch.X`` (a ``monkeypatch.setattr`` in a
  test reaches the port), and which puts the port on ``sys.path`` in any
  process that imports it, so a grandchild started with
  ``PYTHONPATH=<staged root>`` reaches the port too;
* ``jax`` and ``jaxlib`` packages that raise ``ImportError``;
* a stub for each root script that runs the port's counterpart
  (``python GUI_batch_download_plot_FAST.py --tui`` runs the port's
  ``cli.GUI_batch_download_plot_FAST``; ``import single_plot_spectrogram``
  gives the port's ``cli.single_plot_spectrogram``);
* a ``sitecustomize`` that records, in every process started on that path,
  each file it opens under the JAX package or a ``jax*`` directory;
* a pytest plugin in place of ``tests/conftest.py``: the ``rng`` and
  ``synth_archive`` fixtures from the port's ``data.synthetic``, and at
  session end the loaded modules' files and ``ops.kernels.LAUNCHES``.

The port is reached through a ``PYTHONPATH`` entry that holds only a link
to ``configurable_spectrograms_torch``; the checkout's root is never on a
staged process's path.

Each JAX test function gets one verdict: :data:`NOT_APPLICABLE` (with its
reason and the port test that holds the same behaviour), :data:`BASELINE`
(fails on the JAX package itself, for a reason inside the test), or else
``PASS``, one case each below, which passes when every node of the
function passed.  ``chip_smoke.py`` loads this file by path and runs the
same staged run on the card (its ``[suite]`` phase), where
:data:`CARD_EXPECTED` lists what fails there only.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = "configurable_spectrograms_tpu", "configurable_spectrograms_torch"

#: Root script -> the port module that stands in for it.
ROOT_SCRIPTS = {
    "FAST_CDF_download": f"{PORT}.cli.FAST_CDF_download",
    "GUI_batch_download_plot_FAST": f"{PORT}.cli.GUI_batch_download_plot_FAST",
    "batch_multi_plot_FAST_spectrograms": f"{PORT}.cli.batch_multi_plot_FAST_spectrograms",
    "batch_multi_plot_spectrogram": f"{PORT}.batch_multi_plot_spectrogram",
    "single_day_FAST_CDF_download": f"{PORT}.cli.single_day_FAST_CDF_download",
    "single_plot_FAST_spectrograms": f"{PORT}.cli.single_plot_FAST_spectrograms",
    "single_plot_audio_spectrogram": f"{PORT}.cli.audio",
    "single_plot_spectrogram": f"{PORT}.cli.single_plot_spectrogram",
}

#: What the JAX tests read besides themselves, relative to the checkout.
COPIED = ("FAST_Cusp_Indices.csv", "pre_commit_hooks", "tools", "docs", "tests/goldens", "tests/oracle.py",
          "tests/multihost_worker.py", "tests/multihost_flagship_worker.py")


def jax_test_files() -> list[str]:
    """The JAX package's test files, by name."""
    return sorted(p.name for p in (REPO / "tests").glob("test_*.py") if not p.name.startswith("test_torch_"))


def jax_test_functions(files: list[str] | None = None) -> list[str]:
    """Every module-level ``test_*`` function of test *files* (default: the JAX ones), as ``file.py::name``."""
    out = []
    for name in files or jax_test_files():
        tree = ast.parse((REPO / "tests" / name).read_text())
        out += [f"{name}::{node.name}" for node in tree.body
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name.startswith("test_")]
    return out


# -- the staged tree -----------------------------------------------------------------

_RAISE = "raise ImportError('{name} does not exist in the staged run of the JAX suite')\n"

_SHIM = '''\
"""Staged stand-in: ``{jax}.X`` is the module object ``{port}.X``."""
import importlib
import importlib.abc
import importlib.util
import sys

if {port_dir!r} not in sys.path:
    sys.path.append({port_dir!r})


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if not name.startswith("{jax}."):
            return None
        if importlib.util.find_spec("{port}" + name[len("{jax}"):]) is None:
            return None
        return importlib.util.spec_from_loader(name, self)

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        sys.modules[module.__name__] = importlib.import_module("{port}" + module.__name__[len("{jax}"):])


sys.meta_path.insert(0, _Alias())
sys.modules[__name__] = importlib.import_module("{port}")
'''

_ROOT_STUB = '''\
"""Staged stand-in for the root script {name}: the port's {module}."""
import importlib
import runpy
import sys

import {jax}  # noqa: F401  (puts the port on sys.path)

if __name__ == "__main__":
    runpy.run_module("{module}", run_name="__main__", alter_sys=True)
else:
    sys.modules[__name__] = importlib.import_module("{module}")
'''

_SITECUSTOMIZE = '''\
"""Records, in every process of the staged run, its start, its first import of the port, and each file
it opens under the JAX package or a jax* directory; at a normal exit, its jax* and JAX-named modules."""
import json
import os
import sys

_RECORDS = {records!r}
_JAX_DIR = {jax_dir!r}
_STAGE = {stage!r}
_FLAGGED = ("jax", "jaxlib", "jax_plugins")


def _write(kind, **fields):
    with open(os.path.join(_RECORDS, "%d.jsonl" % os.getpid()), "a") as f:
        f.write(json.dumps(dict(kind=kind, pid=os.getpid(), **fields)) + "\\n")


def _is_bad(path):
    real = os.path.realpath(path)
    if real == _JAX_DIR or real.startswith(_JAX_DIR + os.sep):
        return True
    if real.startswith(_STAGE + os.sep):
        return False
    return any(part in _FLAGGED for part in real.split(os.sep))


_PORT_SEEN = []


def _audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        path = os.fsdecode(args[0])
        if _is_bad(path):
            _write("opened", path=path)
    elif event == "import" and not _PORT_SEEN and str(args[0]).split(".")[0] == "configurable_spectrograms_torch":
        _PORT_SEEN.append(True)
        _write("port")


def _snapshot():
    mods = {{}}
    for name, mod in list(sys.modules.items()):
        path = getattr(mod, "__file__", None) or ""
        if name.split(".")[0] in _FLAGGED or name.split(".")[0] == "configurable_spectrograms_tpu" \\
                or (path and _is_bad(path)):
            mods[name] = os.path.realpath(path) if path else path
    _write("exit", modules=mods)


_write("start", argv=list(sys.orig_argv))
sys.addaudithook(_audit)
import atexit  # noqa: E402

atexit.register(_snapshot)
'''

#: A pytest plugin's hook: at session end, the loaded modules' files and ``ops.kernels.LAUNCHES`` as JSON.
_SESSION_REPORT = '''
def pytest_sessionfinish(session, exitstatus):
    kernels = sys.modules.get("{port}.ops.kernels")
    report = {{
        "modules": {{name: os.path.realpath(mod.__file__) if getattr(mod, "__file__", None) else None
                    for name, mod in list(sys.modules.items())}},
        "launches": dict(kernels.LAUNCHES) if kernels is not None else None,
    }}
    with open(os.environ["CST_SUITE_REPORT"], "w") as f:
        json.dump(report, f)
'''

_PLUGIN = '''\
"""The staged run's stand-in for tests/conftest.py."""
import json
import os
import sys
import types

import numpy as np
import pytest

# tests/ is a namespace package here as in the checkout (no __init__.py), so a regular package named
# tests installed in site-packages would win ``from tests.oracle import ...``: bind the name to this tree.
_tests = types.ModuleType("tests")
_tests.__path__ = [os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")]
sys.modules["tests"] = _tests


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def synth_archive(tmp_path_factory):
    from {port}.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("fast_data")
    csv = root / "cusp.tsv"
    orbits = [100, 101, 102]
    mapping = synth_fast_archive(str(root), orbits, n_time=96, n_angle=16, n_energy=24, cusp_csv_path=str(csv))
    return {{"root": str(root), "orbits": orbits, "mapping": mapping, "cusp_csv": str(csv)}}

''' + _SESSION_REPORT


def stage(dest: Path, *, shim: bool = True) -> Path:
    """Build the staged tree under *dest* and return its root (see the module docstring)."""
    root = dest / "stage"
    (root / "tests").mkdir(parents=True)
    for name in jax_test_files():
        shutil.copy2(REPO / "tests" / name, root / "tests" / name)
    for rel in COPIED:
        src = REPO / rel
        if src.is_dir():
            shutil.copytree(src, root / rel, ignore=shutil.ignore_patterns("__pycache__"))
        elif src.is_file():
            shutil.copy2(src, root / rel)
    port_dir = dest / "port"
    port_dir.mkdir()
    (port_dir / PORT).symlink_to(REPO / PORT, target_is_directory=True)
    records = dest / "records"
    records.mkdir()
    for name in ("jax", "jaxlib"):
        (root / name).mkdir()
        (root / name / "__init__.py").write_text(_RAISE.format(name=name))
    if shim:
        (root / JAX).mkdir()
        (root / JAX / "__init__.py").write_text(_SHIM.format(jax=JAX, port=PORT, port_dir=str(port_dir)))
    for name, module in ROOT_SCRIPTS.items():
        (root / f"{name}.py").write_text(_ROOT_STUB.format(name=name, module=module, jax=JAX))
    (root / "sitecustomize.py").write_text(_SITECUSTOMIZE.format(
        records=str(records), jax_dir=str((REPO / JAX).resolve()), stage=str(root.resolve())))
    (root / "cst_suite_plugin.py").write_text(_PLUGIN.format(port=PORT))
    (root / "pytest.ini").write_text("[pytest]\n")
    return root


def staged_env(root: Path, device: str | None) -> dict:
    """The environment of a staged process: the staged root first, the port's link after it."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CST_", "JAX_", "XLA_", "PYTEST_")) and k != "PYTHONPATH"}
    env["PYTHONPATH"] = f"{root}{os.pathsep}{root.parent / 'port'}"
    if device is not None:
        env["CST_TORCH_DEVICE"] = device
    return env


def _node_outcomes(xml_path: Path) -> tuple[dict[str, str], dict[str, float]]:
    """``file.py::node`` -> passed | failed | skipped | uncollected, and each file's seconds, from a junit report.

    A collection error or a module-level skip is recorded under
    ``file.py::`` (every function of that file shares it).
    """
    out, seconds = {}, {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        cls, name = case.get("classname", ""), case.get("name", "")
        kinds = {child.tag for child in case}
        file = (cls or name).split(".")[1] + ".py"  # classname tests.test_x, or a module's name tests.test_x
        seconds[file] = seconds.get(file, 0.0) + float(case.get("time") or 0.0)
        if not cls:  # a collection error or a skip of a whole module
            out[f"{file}::"] = "skipped" if "skipped" in kinds else "uncollected"
            continue
        key = f"{file}::{name}"
        outcome = ("failed" if kinds & {"failure", "error"} else "skipped" if "skipped" in kinds else "passed")
        if out.get(key) not in (None, "passed"):
            continue  # an error in teardown after a failure keeps the failure
        out[key] = outcome
    return out, seconds


def function_outcomes(nodes: dict[str, str], functions: list[str]) -> dict[str, str]:
    """Each JAX test function's outcome: passed only when it has nodes and every one passed."""
    out = {}
    for func in functions:
        file, _, name = func.partition("::")
        mine = [o for k, o in nodes.items() if k.startswith(file + "::")
                and (k.split("::", 1)[1] == name or k.split("::", 1)[1].startswith(name + "["))]
        if f"{file}::" in nodes:
            mine.append(nodes[f"{file}::"])
        if not mine:
            out[func] = "uncollected"
        elif all(o == "passed" for o in mine):
            out[func] = "passed"
        else:
            out[func] = next(o for o in ("failed", "uncollected", "skipped") if o in mine)
    return out


def run_child(cmd: list[str], dest: Path, cwd: Path, env: dict, timeout: float) -> dict:
    """Run the child pytest *cmd* (its junit XML at ``dest/junit.xml``, its report at ``dest/report.json``).

    Returns the node outcomes, the report (the child's modules and
    launches), the records of every process under ``dest/records``, the
    child's exit code, its output's tail and its seconds.
    """
    xml, report = dest / "junit.xml", dest / "report.json"
    env = {**env, "CST_SUITE_REPORT": str(report)}
    t0 = time.perf_counter()
    # A session of its own, so that a time-out stops the grandchildren too.
    proc = subprocess.Popen([*cmd, f"--junitxml={xml}"], cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"the child pytest passed its {timeout} s limit:\n{out[-6000:]}") from None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # any process the run left behind
        except ProcessLookupError:
            pass
    seconds = time.perf_counter() - t0
    nodes, file_seconds = _node_outcomes(xml) if xml.exists() else ({}, {})
    return {
        "returncode": proc.returncode,
        "tail": out[-6000:],
        "seconds": seconds,
        "file_seconds": file_seconds,
        "nodes": nodes,
        "report": json.loads(report.read_text()) if report.exists() else None,
        "processes": [[json.loads(line) for line in rec.read_text().splitlines() if line]
                      for rec in sorted((dest / "records").glob("*.jsonl"))],
    }


def run_staged(dest: Path, files: list[str], *, device: str | None, timeout: float) -> dict:
    """Stage the tree under *dest* and run the JAX test *files* there in one child pytest.

    Returns :func:`run_child`'s result with the per-function outcomes.
    """
    root = stage(dest)
    cmd = [sys.executable, "-m", "pytest", *[f"tests/{f}" for f in files], "-q", "-p", "no:xdist",
           "--noconftest", "-p", "cst_suite_plugin", "-p", "no:cacheprovider", "-p", "no:randomly",
           "--continue-on-collection-errors", "-c", str(root / "pytest.ini"), "--rootdir", str(root)]
    result = run_child(cmd, dest, root, staged_env(root, device), timeout)
    result["functions"] = function_outcomes(result["nodes"], jax_test_functions(files))
    return result


def assert_isolated(result: dict) -> None:
    """No staged process opened a file of the JAX package or of a ``jax*`` package, or kept such a module.

    Every process started on the staged path records itself (``sitecustomize``);
    the child pytest also reports its modules at session end.  Each
    ``configurable_spectrograms_tpu.X`` must be a file of the port (the
    records hold resolved paths: the staged tree may be gone by now).
    """
    port = str((REPO / PORT).resolve())
    bad = []
    for proc in result["processes"]:
        for rec in proc:
            if rec["kind"] == "opened":
                bad.append((rec["pid"], rec["path"]))
            elif rec["kind"] == "exit":
                for name, path in rec["modules"].items():
                    if not name.startswith(JAX) or not path.startswith(port + os.sep):
                        bad.append((rec["pid"], name, path))
    report = result["report"] or {}
    for name, path in (report.get("modules") or {}).items():
        top = name.split(".")[0]
        if top in ("jax", "jaxlib") or (top == JAX and not (path or "").startswith(port + os.sep)):
            bad.append(("child pytest", name, path))
    assert result["report"] is not None, "the child pytest wrote no report:\n" + result["tail"]
    assert not bad, bad


def assert_passed(result: dict, func: str) -> None:
    outcome = result["functions"].get(func, "uncollected")
    file = func.partition("::")[0]
    nodes = {k: v for k, v in result["nodes"].items()
             if k.startswith(func + "[") or k == func or k == f"{file}::"}
    assert outcome == "passed", f"{func}: {outcome} {nodes}\n{result['tail'][-3000:]}"


def stray_not_applicable(result: dict, files: list[str]) -> list[str]:
    """Tests of *files* classed not applicable that passed all the same (they belong in PASS)."""
    return [f for f in NOT_APPLICABLE if f.partition("::")[0] in files and result["functions"].get(f) == "passed"]


# -- the verdicts ----------------------------------------------------------------------

#: Which child run carries each JAX test file: this file's (``a``) or test_torch_jax_suite_b.py's.
SHARDS = {
    "a": ("test_batch_layer.py", "test_cdf_io.py", "test_cli_entry_points.py", "test_compositor.py",
          "test_data_layer.py", "test_device_result_cache.py", "test_doctests.py", "test_exact_percentile.py",
          "test_fuzz_parity.py", "test_golden_figures.py", "test_graft_entry.py", "test_host_backend.py",
          "test_native_blit.py", "test_ops.py", "test_pallas.py"),
    "b": ("test_fast_layer.py", "test_gui_qt.py", "test_multihost.py", "test_orbit_major.py", "test_parallel.py",
          "test_plotting.py", "test_production_sharding.py", "test_progress_ledger.py", "test_quantize_caches.py",
          "test_quantize_path.py", "test_reference_parity.py", "test_render_service.py", "test_slow_dispatch.py",
          "test_stft.py", "test_utils.py", "test_writeback.py"),
}

#: JAX test functions that pass against the port, by file.
PASS = {
    "test_batch_layer.py": (
        "test_run_batch_statuses_and_resume", "test_run_batch_worker_exception", "test_generic_batch_plot",
        "test_download_single_day_mocked", "test_download_threaded_mocked", "test_gui_action_runner",
        "test_fast_batch_config_runs", "test_ephemeris_files_excluded", "test_tui_single_day_flow",
        "test_run_batch_with_process_pool", "test_tui_single_day_files_source",
        "test_single_day_download_by_date_source", "test_render_single_instrument_grid_from_files",
        "test_parse_scale_combos", "test_progress_tail_streams_updates", "test_tui_rejects_bad_combo_spec"),
    "test_cdf_io.py": (
        "test_roundtrip", "test_column_major_roundtrip", "test_nan_preserved", "test_varinq", "test_not_a_cdf",
        "test_missing_variable", "test_v2_roundtrip", "test_v2_column_major", "test_bad_version",
        "test_checksum_roundtrip_and_validation", "test_validate_without_checksum_is_noop",
        "test_libdeflate_inflate_matches_gzip", "test_reader_corruption_robustness",
        "test_corrupt_trailer_size_rejected_without_giant_alloc", "test_column_major_records_not_interleaved",
        "test_column_major_three_axis_records"),
    "test_cli_entry_points.py": (
        "test_single_plot_spectrogram_cli", "test_single_plot_spectrogram_cli_missing_file",
        "test_single_plot_fast_cli_pitch_grid", "test_single_plot_fast_cli_mutually_exclusive", "test_audio_cli",
        "test_day_download_cli_validates_date", "test_year_download_cli_validates_year",
        "test_batch_cli_runs_all_scale_combos", "test_batch_cli_schedule_env_knob",
        "test_run_cli_prints_systemexit_message", "test_load_filtered_orbits_malformed_csv_returns_none"),
    "test_compositor.py": (
        "test_cusp_line_marker_pixels", "test_cusp_bracket_below_axis", "test_nonunix_x_axis_ticks",
        "test_colorbar_gradient_present", "test_single_sample_window", "test_stft_empty_signal",
        "test_canvas_pool_never_aliases_live_images", "test_canvas_pool_recycles_after_collection",
        "test_fill_outside_whitens_exactly_the_complement", "test_poisoned_recycled_canvas_renders_identically",
        "test_save_image_png_write_is_atomic", "test_copy_saved_png_is_atomic"),
    "test_data_layer.py": (
        "test_get_cdf_file_type", "test_extract_orbit_and_instrument", "test_parse_year_month",
        "test_classify_error_reason", "test_get_timestamps_for_orbit", "test_orbit_row_cache_semantics",
        "test_orbit_row_cache_sees_inplace_mutation", "test_resolve_shared_orbit_and_from_files",
        "test_synth_archive_discovery_and_load", "test_load_transposes_energy_major", "test_load_filtered_orbits",
        "test_resolve_shared_orbit_tie_breaks_low", "test_real_cusp_indices_dataset",
        "test_oversized_dataset_load_leaves_cache_intact", "test_dataset_load_single_flight",
        "test_dataset_load_single_flight_loader_failure_recovers",
        "test_synth_nondefault_instrument_varies_per_orbit"),
    "test_exact_percentile.py": (
        "test_tracker_bit_equal_to_nanpercentile_brute_force", "test_tracker_drift_regather_path",
        "test_tracker_empty_and_single", "test_percentile_ranks_match_numpy_float32_semantics",
        "test_compute_global_extrema_exact_matches_reference_replay",
        "test_compute_global_extrema_histogram_mode_still_available",
        "test_tracker_memory_bounded_with_alternating_percentiles",
        "test_tracker_retains_nothing_before_first_query", "test_interval_helpers",
        "test_window_cap_drops_least_recently_queried", "test_lerp_infinite_stats_silent_and_numpy_equal"),
    "test_fast_layer.py": (
        "test_extrema_overrides", "test_pitch_angle_grid_rows_and_title", "test_instrument_grid_rows_and_extrema",
        "test_instrument_grid_missing_and_broken_files", "test_compute_global_extrema_cache_and_reuse",
        "test_extrema_z_within_tolerance_of_exact", "test_process_single_orbit_outputs",
        "test_process_single_orbit_skip_existing", "test_process_single_orbit_timeout",
        "test_batch_directory_run_and_resume", "test_batch_directory_error_taxonomy",
        "test_compute_global_extrema_with_mins", "test_get_cdf_var_shapes", "test_esv_instrument_opt_in",
        "test_paced_gc_limits_full_collections", "test_gc_interval_env_malformed_falls_back",
        "test_sweep_keeps_live_concurrent_tmp"),
    "test_gui_qt.py": (
        "test_run_qt_navigation_and_theme", "test_download_page_chips_feed_the_runner",
        "test_download_page_requires_a_year", "test_plot_page_percentile_slider_linked",
        "test_plot_page_start_progress_and_stop", "test_single_day_pages_run_and_validate",
        "test_main_headless_env_routes_to_qt"),
    "test_host_backend.py": (
        "test_host_collapse_matches_nansum", "test_host_quantize_matches_oracle", "test_host_quantize_empty",
        "test_cached_collapse_cross_render_reuse", "test_canvas_pool_keeps_recycling_past_size_cap",
        "test_canvas_pool_never_recycles_externally_held_buffer", "test_percentile_bounds_cache_shared_across_panels"),
    "test_orbit_major.py": (
        "test_orbit_major_matches_combo_major", "test_orbit_major_decodes_each_file_once",
        "test_orbit_major_resume_skips_everything", "test_fast_batch_config_schedule_dispatch"),
    "test_plotting.py": (
        "test_make_spectrogram_returns_axis_and_xplot", "test_make_spectrogram_empty_paths",
        "test_make_spectrogram_zoom_filters_xplot", "test_vertical_lines_filtered_to_extent",
        "test_red_heavy_colormap_line_color", "test_generic_set_renders_png", "test_generic_set_empty",
        "test_multirow_zoom_decision", "test_multirow_two_marker_window_expansion",
        "test_multirow_row_labels_and_footer", "test_close_all_axes_and_clear", "test_collapse_axis_2",
        "test_locators", "test_unsorted_x_is_sorted", "test_stage_timer_and_trace",
        "test_negative_y_max_ticks_do_not_crash"),
    "test_progress_ledger.py": (
        "test_ledger_error_taxonomy", "test_ledger_timeout_keys_and_clear", "test_ledger_flush_cadence",
        "test_ledger_resume_state", "test_render_loop_memory_stable", "test_ledger_accumulates_between_flushes"),
    "test_quantize_caches.py": (
        "test_warm_repeat_is_bit_identical", "test_zoom_window_gets_its_own_safe_vmin",
        "test_linear_nonfinite_bounds_fallback_matches_cold", "test_nan_bounds_fallback_maps_nan_cells_to_lut0",
        "test_log_nan_span_pins_whole_panel_to_lut0", "test_owner_death_evicts_derived_entries",
        "test_idx_cache_distinguishes_scales_and_bounds"),
    "test_render_service.py": (
        "test_coalesced_matches_direct", "test_concurrent_requests_pool_correctly",
        "test_mixed_geometries_concurrently", "test_empty_request", "test_concurrent_workers_through_coalescer_sharded",
        "test_coalescer_drainer_failure_fails_futures"),
    "test_utils.py": (
        "test_round_extrema", "test_compute_percentile_bounds", "test_buffered_logging",
        "test_get_logfile_path_marker_reuse", "test_progress_store_batched_flush", "test_progress_store_none_path",
        "test_atomic_write_json_roundtrip_and_no_litter", "test_atomic_write_json_failure_preserves_old_state",
        "test_progress_store_flush_failure_keeps_previous_file", "test_add_to_orbit_list",
        "test_resident_cache_bounds_and_owner_eviction", "test_resident_cache_concurrent_inserts_and_owner_death"),
    "test_writeback.py": (
        "test_note_written_fsyncs_file", "test_note_written_missing_file_is_harmless", "test_disabled_by_env",
        "test_save_image_routes_through_pacer"),
}

_LINK = "rule 5: reaches render.link (the TPU relay's probes, calibration, watchdog and soft caps)"
_RESULTS = "rule 5: reaches render.device_results (the relay's resident result cache)"
_XLA = "needs XLA: utils.jax_setup and its compilation cache"
_PROBE = ("reaches render.fastpng.native_available, left out in tests/test_torch_api_surface.py: the port has no "
          "fallback encoder, so there is nothing to probe for")
_BACKEND = "pokes a private of the JAX package: the render backend's _BACKEND dict"
_JAX = "imports jax to build its inputs or its reference"
_WORKER = "its worker processes import jax (tests/multihost_worker.py, tests/multihost_flagship_worker.py)"
_TREE = ("reads the JAX package's source files: pre_commit_hooks/run_doctests.py walks configurable_spectrograms_tpu/ "
         "on disk, and the staged package is the one-file shim")
# Why a test that cannot run against the port has no port test that carries its assertion:
_TILE = ("imports jax; it pins a Pallas tiling knob (t_tile, CST_PALLAS_T_TILE): the CUDA kernels take no tile size, "
         "and chip_smoke.py's [sweep] holds each kernel to its plain version across the shapes that set its tiling")
_SHARDED_XLA = ("imports jax; it pins what XLA compiles under a mesh (a sharded program's per-device cost, the XLA "
                "program kept under a mesh): the port's production dispatch has no mesh, one rank renders on one card")
_HANG = ("imports jax; it pins the bounded dispatch (CST_DEVICE_DISPATCH_TIMEOUT) and its fall-back to the host, which "
         "stay behind with render.link (rule 5): in the port a CUDA error raises and nothing falls back")
_NO_GATE = ("the port has no compute gate: it never bound at the port's ≤4 workers on 8 cores "
            "(PERF.md: the back-end switches and the stage timings), so it was removed")
_A = "test_torch_jax_assertions.py::"
_C = "test_torch_suite_counterparts.py::"
_DRYRUN = "test_torch_parallel.py::test_dryrun_multichip_two_gloo_ranks_on_the_cpu"


def _na(file: str, reason: str, **counterparts: str | None) -> dict:
    return {f"{file}::{name}": (reason, port) for name, port in counterparts.items()}


def _same(file: str, reason: str, *names: str) -> dict:
    """Entries whose port test is the one of the same name in test_torch_jax_assertions.py."""
    return _na(file, reason, **{name: _A + name for name in names})


#: JAX test function -> (why it cannot run against the port, the port test that makes its assertions, or None).
#: A port test named here names the JAX test in its docstring and does not reach the JAX package
#: (:func:`counterpart_problems`).
NOT_APPLICABLE = {
    **_na("test_compositor.py", _PROBE,
          test_fastpng_roundtrip=_C + "test_fastpng_roundtrip_on_every_encoder_path",
          test_fastpng_rle_encoder_roundtrip=_C + "test_fastpng_roundtrip_on_every_encoder_path",
          test_fastpng_concurrent_encodes=_C + "test_fastpng_concurrent_encodes"),
    **_same("test_compositor.py", _BACKEND, "test_recommended_workers_host_vs_device"),
    **_na("test_compositor.py", _LINK, test_canvas_pool_depth_follows_worker_demand=_C + "test_canvas_pool_depth_follows_worker_demand"),
    **_na("test_device_result_cache.py", _RESULTS, test_repeat_render_serves_from_cache_bit_identical=None,
          test_cache_key_sensitivity=None, test_cache_disabled_by_env=None, test_owner_death_evicts_entries=None,
          test_host_backend_never_consults_the_cache=None, test_cached_and_host_results_agree=None),
    **_na("test_doctests.py", _TREE, test_doctest_harness_passes="test_torch_doctests.py::test_module_doctests_pass"),
    **_na("test_fuzz_parity.py", _JAX,
          test_equal_bounds_paint_whole_panel_lut0=_C + "test_equal_bounds_paint_whole_panel_lut0",
          test_fuzz_host_vs_device_quantize=_A + "test_fuzz_host_vs_device_quantize",
          test_nan_percentile_bounds_pin_lut0_on_both_backends=_C + "test_nan_percentile_bounds_pin_lut0_on_both_backends"),
    **_same("test_golden_figures.py", _BACKEND, "test_golden_figure", "test_golden_fast_grid_200dpi",
            "test_golden_audio_mel"),
    **_na("test_graft_entry.py", _JAX, test_entry_forward_jits=_A + "test_entry_forward_jits",
          test_dryrun_multichip_eight=_DRYRUN, test_ensure_devices_provisions_virtual_cpus=_DRYRUN),
    **_same("test_host_backend.py", _BACKEND, "test_host_backend_full_figure"),
    **_na("test_host_backend.py", _LINK, test_auto_backend_calibration_flip=None, test_reprobe_restores_device_backend=None,
          test_cold_link_warm_start_promotion=None, test_dead_link_stays_host=None, test_reprobe_not_due_is_noop=None,
          test_bandwidth_preselection=None, test_probe_without_bandwidth_counts_as_healthy=None),
    **_same("test_multihost.py", _WORKER, "test_two_process_extrema_reduction",
            "test_two_process_flagship_batch_matches_single_host"),
    **_same("test_native_blit.py", _PROBE, "test_blit_matches_numpy_tail", "test_blit_into_clipped_view",
            "test_blit_pre_gathered", "test_blit_falls_back_on_unsupported_layout", "test_blend_tile_exhaustive_triples",
            "test_blend_tile_random_placement_and_clipping", "test_blend_tile_into_strided_canvas_rows",
            "test_blend_tile_declines_bad_layouts", "test_blend_probe_validates_against_pillow",
            "test_canvas_blender_matches_blend_tile", "test_canvas_blender_declines_bad_canvases"),
    **_same("test_ops.py", _JAX, "test_collapse_cube_matches_nansum", "test_collapse_cube_empty_mask_and_padding",
            "test_masked_nanpercentile", "test_render_matrix_parity_all_scales",
            "test_render_matrix_energy_range_and_explicit_bounds", "test_render_matrix_zoom_window_with_margins",
            "test_render_matrix_all_nan_column_and_empty", "test_render_matrix_matches_matplotlib_imshow",
            "test_render_matches_matplotlib_log_y", "test_render_matrix_fuzz_vs_oracle"),
    **_na("test_ops.py", _JAX, test_masked_nanpercentile_empty=_C + "test_masked_nanpercentile_empty_and_infinities",
          test_masked_nanpercentile_with_inf=_C + "test_masked_nanpercentile_empty_and_infinities"),
    **_same("test_pallas.py", _JAX, "test_collapse_cube_pallas_matches_jnp", "test_collapse_cube_pallas_shape_gate",
            "test_fused_quantize_pallas_matches_jnp", "test_fused_quantize_pallas_shape_gate",
            "test_render_kernel_pallas_production_switch"),
    **_na("test_pallas.py", _TILE, test_fused_quantize_pallas_t_tile_invariant=None, test_pallas_t_tile_env_knob=None),
    **_na("test_pallas.py", _SHARDED_XLA, test_render_kernel_pallas_stays_xla_when_sharded=None),
    **_same("test_parallel.py", _JAX, "test_make_mesh_shapes", "test_sharded_extrema_matches_single_device",
            "test_sharded_render_matches_single_device", "test_sharded_render_rejects_bad_batch",
            "test_data_parallel_mesh_never_enumerates_devices_on_host_backend"),
    **_na("test_parallel.py", _JAX,
          test_init_distributed_forwards_arguments="test_torch_parallel.py::test_init_distributed_forwards_arguments"),
    **_same("test_production_sharding.py", _JAX, "test_production_render_spans_mesh_and_matches_unsharded",
            "test_batched_file_stats_sharded_matches_unsharded", "test_extrema_scan_identical_with_and_without_mesh",
            "test_host_file_stats_matches_device", "test_repeat_render_reuses_resident_cubes",
            "test_explicit_bounds_program_shards_and_matches", "test_mixed_bucket_group_shards_and_matches"),
    **_na("test_production_sharding.py", _JAX,
          test_inverted_log_bounds_error_scoped_to_owning_figure=_C + "test_inverted_log_bounds_error_scoped_to_owning_figure"),
    **_na("test_production_sharding.py", _HANG, test_hung_dispatch_falls_back_to_host=None,
          test_forced_device_hung_dispatch_raises=None, test_hung_extrema_dispatch_falls_back_to_host=None),
    **_na("test_production_sharding.py", _SHARDED_XLA, test_sharded_quantize_partitions_compute_not_just_outputs=None,
          test_sharded_extrema_partitions_compute=None),
    **_same("test_quantize_path.py", _JAX, "test_host_resample_matches_device_render", "test_pre_gather_path_matches_direct",
            "test_device_cube_cache_reuse_and_eviction"),
    **_na("test_quantize_path.py", _JAX, test_host_resample_empty=_C + "test_host_resample_empty"),
    **_same("test_render_service.py", _LINK, "test_multi_bucket_readbacks_overlap", "test_bucket_readback_error_propagates",
            "test_coalescer_overlaps_batches"),
    **_na("test_render_service.py", _NO_GATE, test_host_compute_gate_bounds_concurrency=None),
    **_na("test_render_service.py", _LINK, test_watchdog_trip_uses_landed_siblings=None,
          test_stale_probe_cannot_repromote_after_dispatch_failure=None, test_sibling_batches_fast_trip_after_watchdog=None),
    **_na("test_slow_dispatch.py", _LINK, **{name: None for name in (
        "test_slow_streak_trips_to_host_with_reason", "test_one_fast_batch_resets_the_streak",
        "test_severe_stall_trips_without_waiting_for_streak", "test_fast_device_batches_never_trip",
        "test_mildly_slower_than_host_does_not_trip", "test_slow_without_host_rate_arms_probation_not_blind_trip",
        "test_probation_group_renders_host_and_measures", "test_probation_disarms_once_host_is_measured_elsewhere",
        "test_host_rate_measured_from_note_host_group", "test_reset_rate_state_clears_streak_and_probation",
        "test_slow_trip_stamps_failure_ts_for_siblings", "test_pipelined_batches_not_billed_shared_wall_clock",
        "test_idle_gap_not_billed_to_device", "test_detector_baseline_ratchet_is_bounded",
        "test_soft_cap_trips_one_giant_stalled_bucket", "test_soft_cap_scales_with_bucket_size_and_uploads",
        "test_soft_drain_cap_adapts_to_healthy_baseline", "test_soft_cap_expiry_waits_when_host_is_slower",
        "test_soft_cap_expiry_without_host_evidence_does_not_force", "test_fresh_compile_bucket_exempt_from_soft_cap",
        "test_bootstrap_cap_derived_from_probe_measurement", "test_bootstrap_cap_flat_without_probe_measurement",
        "test_first_bucket_stall_trips_under_derived_bootstrap", "test_degraded_but_host_no_faster_stays_on_device",
        "test_latency_policy_routes_relay_to_host", "test_latency_policy_keeps_device_on_direct_attach",
        "test_latency_policy_no_link_measurement_keeps_device", "test_latency_policy_disabled_by_env",
        "test_latency_policy_inactive_outside_auto", "test_latency_upload_estimate_dedups_shared_cubes",
        "test_prefer_latency_renders_host_on_slow_link", "test_prefer_latency_ignored_for_fast_link",
        "test_slow_dispatch_end_to_end_fallback")}),
    **_same("test_stft.py", _JAX, "test_frame_signal", "test_stft_pure_tone_peak", "test_stft_matches_numpy",
            "test_mel_scale_roundtrip", "test_mel_filterbank_shapes_and_coverage", "test_mel_spectrogram_shape_and_energy",
            "test_audio_dataset_renders", "test_wav_cli_roundtrip", "test_stft_matmul_matches_fft",
            "test_stft_unknown_method_raises", "test_mel_spectrogram_method_passthrough", "test_host_stft_matches_device",
            "test_audio_dataset_host_fallback", "test_audio_dataset_rejects_bad_method_on_both_backends",
            "test_audio_dataset_hung_device_falls_back", "test_pallas_stft_matches_matmul",
            "test_pallas_stft_magnitude_power_one", "test_dataset_accepts_pallas_method"),
    **_na("test_utils.py", _XLA, test_compile_cache_dir_is_machine_fingerprinted=None,
          test_compile_cache_skipped_on_cpu_backend=None),
}

_REASONS = (_LINK, _RESULTS, _XLA, _PROBE, _BACKEND, _JAX, _WORKER, _TREE, _TILE, _SHARDED_XLA, _HANG,
            _NO_GATE)


# -- the counterparts ------------------------------------------------------------------

#: The packages a counterpart may not reach.
_JAX_TOPS = ("jax", "jaxlib", JAX)


def _import_tops(node: ast.AST) -> tuple[set[str], set[str]]:
    """(top-level packages imported, names bound) by one ``import`` / ``from ... import`` node."""
    if isinstance(node, ast.Import):
        return {a.name.split(".")[0] for a in node.names}, {(a.asname or a.name).split(".")[0] for a in node.names}
    if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
        return {node.module.split(".")[0]}, {a.asname or a.name for a in node.names}
    return set(), set()


def _jax_bound_names(tree: ast.Module) -> set[str]:
    """Module-level names bound to jax or the JAX package: its imports, and ``x = pytest.importorskip("jax...")``."""
    names = set()
    for node in tree.body:
        tops, bound = _import_tops(node)
        if tops & set(_JAX_TOPS):
            names |= bound
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and node.value.args \
                and ast.unparse(node.value.func).endswith("importorskip") \
                and isinstance(node.value.args[0], ast.Constant) \
                and str(node.value.args[0].value).split(".")[0] in _JAX_TOPS:
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def reaches_jax(file: str, func: str) -> list[str]:
    """How test *func* of *file* reaches jax or the JAX package, through the module's own helpers and fixtures.

    Each finding is an import of those packages in the function or a
    helper it calls (or a fixture it takes), or a use of a module-level
    name bound to them.  Empty: the test's references are independent of
    the JAX package.
    """
    tree = ast.parse((REPO / "tests" / file).read_text())
    defs = {n.name: n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    bad_names = _jax_bound_names(tree)
    found, seen, todo = [], set(), [func]
    while todo:
        name = todo.pop()
        if name in seen or name not in defs:
            continue
        seen.add(name)
        node = defs[name]
        todo += [a.arg for a in node.args.args]  # fixtures of this module
        for sub in ast.walk(node):
            tops, _ = _import_tops(sub)
            if tops & set(_JAX_TOPS):
                found.append(f"{name} imports {sorted(tops & set(_JAX_TOPS))}")
            if isinstance(sub, ast.Name):
                if sub.id in bad_names:
                    found.append(f"{name} uses {sub.id}")
                elif sub.id in defs:
                    todo.append(sub.id)
    return sorted(set(found))


def counterpart_problems(entries: dict) -> list[str]:
    """What is wrong with the port test each *entries* item names (``NOT_APPLICABLE``'s shape).

    The test must exist, name the JAX test's id (``file.py::name``) in its
    docstring, and hold the port to a reference other than the JAX
    package: it may not reach jax or the JAX package (:func:`reaches_jax`).
    """
    problems = []
    for jax_id, (_, port) in entries.items():
        if port is None:
            continue
        file, _, name = port.partition("::")
        tree = ast.parse((REPO / "tests" / file).read_text())
        node = next((n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                     and n.name == name), None)
        if node is None:
            problems.append(f"{jax_id}: no port test {port}")
            continue
        if not re.search(re.escape(jax_id) + r"(?![\w])", ast.get_docstring(node) or ""):
            problems.append(f"{jax_id}: the docstring of {port} does not name it")
        problems += [f"{jax_id}: {port} reaches the JAX package ({how})" for how in reaches_jax(file, name)]
    return problems


# -- the port's tests that carry the JAX tests' assertions, run in a child as on the card --

#: The files of those tests; ``chip_smoke.py``'s ``[suite]`` runs them on the card after the staged run.
ASSERTION_FILES = ("tests/test_torch_jax_assertions.py", "tests/test_torch_suite_counterparts.py")

#: Tests of test_torch_jax_assertions.py whose ranks and references all run on the CPU (Gloo), whatever the device.
_CPU_RANK_TESTS = (
    "test_make_mesh_shapes", "test_sharded_extrema_matches_single_device", "test_sharded_render_matches_single_device",
    "test_sharded_render_rejects_bad_batch", "test_production_render_spans_mesh_and_matches_unsharded",
    "test_explicit_bounds_program_shards_and_matches", "test_mixed_bucket_group_shards_and_matches",
    "test_batched_file_stats_sharded_matches_unsharded", "test_extrema_scan_identical_with_and_without_mesh",
    "test_two_process_extrema_reduction", "test_two_process_flagship_batch_matches_single_host",
)

#: Tests of :data:`ASSERTION_FILES` that the child leaves out, with the reason.
ASSERTION_DESELECTED = {
    "tests/test_torch_suite_counterparts.py::test_long_record_renders_the_jax_packages_pixels":
        "compares the port with the JAX package, which the child may not load; "
        "test_torch_jax_assertions.py::test_pre_gather_path_matches_direct holds the JAX test's own assertion",
    **{f"tests/test_torch_jax_assertions.py::{name}":
       "its ranks and its references run on the CPU (Gloo), as in tier-1, so the card adds nothing to it but "
       "its processes' start-up; chip_smoke.py's [parallel] holds the parallel layer on the card"
       for name in _CPU_RANK_TESTS},
}

_FREETYPE = ("the card's machine rasterizes and measures the bundled font with another FreeType (2.14.3 under "
             "PIL 12.2.0; the goldens were made under 2.14.1): besides the glyphs, the figure's margins come from "
             "measured text (compositor._Layout), so the data tiles move or resize by a pixel and re-sample their "
             "columns.  chip_smoke.py's [font] bounds the pitch grid's share at 2%")

#: Tests of :data:`ASSERTION_FILES` that fail on the card only, with the reason.
CARD_EXPECTED_ASSERTIONS: dict[str, str] = {
    "test_torch_jax_assertions.py::test_golden_figure": _FREETYPE,
    "test_torch_jax_assertions.py::test_golden_fast_grid_200dpi": _FREETYPE,
    "test_torch_jax_assertions.py::test_golden_audio_mel": _FREETYPE,
}

_REPORT_PLUGIN = '''\
"""The assertion child's report of its modules and kernel launches."""
import json
import os
import sys

''' + _SESSION_REPORT


def run_assertions(dest: Path, device: str, timeout: float, select: str | None = None) -> dict:
    """Run :data:`ASSERTION_FILES` on *device* in one child pytest that cannot load jax or the JAX package.

    The child runs from *dest*, not the checkout, with ``--noconftest``
    (tests/conftest.py imports jax); its path holds packages named
    ``jax``, ``jaxlib`` and ``configurable_spectrograms_tpu`` that raise
    ``ImportError``, the staged run's ``sitecustomize`` recorder (in it and
    in every process it starts), a plugin that reports its modules and
    kernel launches, and a link to the port.  *select* is a ``-k``
    expression.  Returns :func:`run_child`'s result.
    """
    site = dest / "site"
    site.mkdir(parents=True)
    (dest / "port").mkdir()
    (dest / "port" / PORT).symlink_to(REPO / PORT, target_is_directory=True)
    records = dest / "records"
    records.mkdir()
    for name in _JAX_TOPS:
        (site / name).mkdir()
        (site / name / "__init__.py").write_text(_RAISE.format(name=name))
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE.format(
        records=str(records), jax_dir=str((REPO / JAX).resolve()), stage=str(site.resolve())))
    (site / "cst_assert_report.py").write_text(_REPORT_PLUGIN.format(port=PORT))
    (site / "pytest.ini").write_text("[pytest]\n")
    cmd = [sys.executable, "-m", "pytest", *[str(REPO / f) for f in ASSERTION_FILES], "-q", "-p", "no:xdist",
           "--noconftest", "-p", "cst_assert_report", "-p", "no:cacheprovider", "-p", "no:randomly",
           "-c", str(site / "pytest.ini"), "--rootdir", str(REPO)]
    for node in ASSERTION_DESELECTED:
        cmd += ["--deselect", node]
    if select:
        cmd += ["-k", select]
    return run_child(cmd, dest, dest, staged_env(site, device), timeout)


def assertion_failures(result: dict) -> tuple[list[str], list[str]]:
    """(every failed or uncollected node, those not explained by :data:`CARD_EXPECTED_ASSERTIONS`)."""
    failed = sorted(k for k, v in result["nodes"].items() if v in ("failed", "uncollected"))
    if result["returncode"] not in (0, 1) or not result["nodes"]:
        failed.append(f"the child pytest exited with {result['returncode']}")
    expected = {k.partition("[")[0] for k in CARD_EXPECTED_ASSERTIONS}
    return failed, [f for f in failed if f.partition("[")[0] not in expected]


#: JAX test functions that do not pass on the JAX package itself, for a reason inside the test.
BASELINE = {
    "test_fast_layer.py::test_driver_sweeps_stale_tmp_files":
        "its 'stale' tmp file names pid 123, which is alive on the test machine, so the sweep keeps it",
    "test_reference_parity.py::test_api_reference_doc_is_fresh":
        "docs/api_reference.md is stale on the seed (a rerun of tools/gen_api_reference.py, which writes docs only)",
    "test_reference_parity.py::test_data_region_parity_vs_reference":
        "skips: needs a checkout of the upstream reference project (CST_REFERENCE_ROOT or the test's default path)",
    "test_reference_parity.py::test_api_parity_audit_no_missing_symbols":
        "skips: needs a checkout of the upstream reference project (CST_REFERENCE_ROOT or the test's default path)",
}

#: PASS tests that fail on the card only, with the reason (chip_smoke.py's [suite] holds the rest).
CARD_EXPECTED: dict[str, str] = {}


def pass_cases(shard: str) -> list[str]:
    return [f"{file}::{name}" for file in SHARDS[shard] for name in PASS.get(file, ())]


def test_every_jax_test_function_has_exactly_one_verdict():
    files = jax_test_files()
    sharded = [f for shard in SHARDS.values() for f in shard]
    assert sorted(sharded) == files, "each JAX test file must be in exactly one shard"
    functions = jax_test_functions(files)
    passing = [f"{file}::{name}" for file, names in PASS.items() for name in names]
    classes = passing + list(NOT_APPLICABLE) + list(BASELINE)
    assert sorted(classes) == sorted(functions), {
        "unclassified": sorted(set(functions) - set(classes)),
        "not a JAX test function": sorted(set(classes) - set(functions)),
        "in two classes": sorted({f for f in classes if classes.count(f) > 1}),
    }
    assert not set(CARD_EXPECTED) - set(passing)
    for func, (reason, port) in NOT_APPLICABLE.items():
        assert reason in _REASONS, func
        if port is not None:
            assert port in jax_test_functions([port.partition("::")[0]]), f"{func}: no port test {port}"


def test_every_counterpart_names_its_jax_test_and_holds_an_independent_reference():
    """Each port test ``NOT_APPLICABLE`` names carries that JAX test's id in its docstring and reaches
    neither jax nor the JAX package: the port is held to the JAX test's own reference, not to the JAX package."""
    assert not counterpart_problems(NOT_APPLICABLE)
    assert sum(port is not None for _, port in NOT_APPLICABLE.values()) == 85


def test_the_counterpart_check_sees_a_missing_id_and_a_jax_reference():
    """The check above fails an entry whose port test does not name it, and one whose only reference is the JAX package."""
    stft = "test_stft.py::test_stft_matches_numpy"
    assert counterpart_problems({stft: (_JAX, _A + "test_stft_matches_numpy")}) == []
    wrong_id = counterpart_problems({stft: (_JAX, _A + "test_stft_pure_tone_peak")})
    assert wrong_id == [f"{stft}: the docstring of {_A}test_stft_pure_tone_peak does not name it"]
    jax_only = counterpart_problems({stft: (_JAX, "test_torch_stft.py::test_stft_magnitude_matches_jax_per_method")})
    assert len(jax_only) == 2 and "does not name it" in jax_only[0]
    assert "reaches the JAX package (test_stft_magnitude_matches_jax_per_method uses jstft)" in jax_only[1]
    helper = counterpart_problems({"test_native_blit.py::test_blit_matches_numpy_tail":
                                   (_PROBE, "test_torch_fastpng.py::test_blit_matches_numpy_tail_and_jax")})
    assert any("_three_ways uses jtile" in p for p in helper), helper  # found through a helper
    assert counterpart_problems({stft: (_JAX, _A + "test_no_such_test")}) == [f"{stft}: no port test {_A}test_no_such_test"]


# -- shard a's run, and the proof of isolation -------------------------------------------


@pytest.fixture(scope="module")
def suite(tmp_path_factory) -> dict:
    return run_staged(tmp_path_factory.mktemp("jax_suite_a"), list(SHARDS["a"]), device="cpu", timeout=900)


@pytest.mark.parametrize("func", pass_cases("a"))
def test_jax_test_passes_on_the_port(func, suite):
    assert_passed(suite, func)


def test_not_applicable_tests_do_not_pass(suite):
    assert not stray_not_applicable(suite, SHARDS["a"]), "these pass now: move them to PASS"


def test_no_staged_process_loaded_jax_or_the_jax_package(suite):
    assert_isolated(suite)
    argvs = [" ".join(proc[0]["argv"]) for proc in suite["processes"] if proc and proc[0]["kind"] == "start"]
    assert sum("GUI_batch_download_plot_FAST.py --tui" in a for a in argvs) == 3, argvs
    assert any("spawn_main" in a for a in argvs), argvs
    ported = {proc[0]["pid"] for proc in suite["processes"] if any(r["kind"] == "port" for r in proc)}
    tui = {proc[0]["pid"] for proc in suite["processes"] if "--tui" in proc[0]["argv"]}
    assert tui <= ported, "a TUI child never imported the port"


_GRANDCHILD = """\
import subprocess, sys
code = ("import os, configurable_spectrograms_tpu.render.figure as f, configurable_spectrograms_torch.render.figure as t; "
        "print(os.path.realpath(f.__file__), f is t)")
proc = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": sys.argv[1], "PATH": "/usr/bin:/bin"},
                      capture_output=True, text=True, timeout=120)
print(proc.returncode)
print(proc.stdout.strip())
print(proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else "")
"""


def _grandchild(tmp_path: Path, shim: bool) -> list[str]:
    root = stage(tmp_path, shim=shim)
    proc = subprocess.run([sys.executable, "-c", _GRANDCHILD, str(root)], env=staged_env(root, "cpu"),
                          cwd=tmp_path, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def test_a_staged_grandchild_gets_the_port(tmp_path):
    """A grandchild started as the JAX tests start theirs (``PYTHONPATH=<staged root>`` alone) gets the port."""
    rc, out, _ = _grandchild(tmp_path, shim=True)
    assert rc == "0", out
    path, same = out.rsplit(" ", 1)
    assert path == str((REPO / PORT / "render" / "figure.py").resolve()) and same == "True"


def test_without_the_shim_the_grandchild_import_fails(tmp_path):
    rc, _, err = _grandchild(tmp_path, shim=False)
    assert rc != "0" and "No module named 'configurable_spectrograms_tpu'" in err, err


@pytest.mark.parametrize("breach", ["opens_a_jax_package_file", "imports_the_real_jax"])
def test_the_isolation_check_sees_a_breach(breach, tmp_path):
    """The records of a staged process that reads the JAX package, or gets past the ``jax`` stub, fail the check."""
    root = stage(tmp_path)
    code = {
        "opens_a_jax_package_file": f"open({str(REPO / JAX / 'ops' / 'stft.py')!r}).read()",
        "imports_the_real_jax": f"import sys; sys.path.remove({str(root)!r}); import jax",
    }[breach]
    proc = subprocess.run([sys.executable, "-c", code], env=staged_env(root, "cpu"), cwd=tmp_path,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    records = [[json.loads(line) for line in p.read_text().splitlines()] for p in (tmp_path / "records").glob("*.jsonl")]
    with pytest.raises(AssertionError):
        assert_isolated({"processes": records, "report": {"modules": {}}, "tail": ""})


def test_the_assertion_child_runs_isolated_and_reports_its_launches(tmp_path):
    """chip_smoke.py's second [suite] child, here on the CPU and on a few tests: they pass, the deselected test
    stays out, no process loads jax or the JAX package, and the report carries the kernels' launch counts."""
    for node in ASSERTION_DESELECTED:
        file, _, name = node.partition("::")
        assert f"{Path(file).name}::{name}" in jax_test_functions([Path(file).name]), node
    select = "test_frame_signal or test_collapse_cube_matches_nansum or test_masked_nanpercentile_empty or test_long_record"
    result = run_assertions(tmp_path, "cpu", timeout=600, select=select)
    failed, unexplained = assertion_failures(result)
    assert not failed and not unexplained, result["tail"]
    assert sorted(result["nodes"]) == [
        "test_torch_jax_assertions.py::test_collapse_cube_matches_nansum", "test_torch_jax_assertions.py::test_frame_signal",
        "test_torch_suite_counterparts.py::test_masked_nanpercentile_empty_and_infinities"], result["nodes"]
    assert set(result["nodes"].values()) == {"passed"}
    assert result["report"]["launches"] == {"collapse": 0, "fused_quantize": 0, "stft_power": 0,
                                            "percentile_quantize": 0}  # the CPU launches none
    assert_isolated(result)
    assert any(proc and proc[0]["kind"] == "start" for proc in result["processes"])
