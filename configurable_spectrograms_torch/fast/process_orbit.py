"""Per-orbit FAST spectrogram processing (the batch work unit).

Behavioral parity with reference fast/process_orbit.py:17-300: per
instrument, pitch-angle grids render twice (``given_extrema`` and ``raw``
variants), then instrument grids twice; outputs use the exact reference
filename scheme under ``{base}/{year}/{month}/{orbit}``; soft
per-instrument and per-orbit timeouts mark the result ``timeout`` and
abort remaining work; ``override_plots=False`` skips existing files before
any rendering happens.  Each stage's given/raw figure pair rasterizes in
one pooled device batch.

Port of the JAX package's ``fast/process_orbit.py``: the given-extrema
figures run the fused quantize kernel and the raw figures the collapse
kernel (see :mod:`configurable_spectrograms_torch.render.dispatch`).
"""

from __future__ import annotations

import gc
import os
import time
from typing import Any

from configurable_spectrograms_torch.constants import FAST_SAVE_DPI
from configurable_spectrograms_torch.data.cdf_utils import (
    get_cdf_file_type,
    get_timestamps_for_orbit,
    load_fast_cdf_dataset,
)
from configurable_spectrograms_torch.data.orbit_discovery import parse_year_month
from configurable_spectrograms_torch.fast.constants import DEFAULT_INSTRUMENT_ORDER
from configurable_spectrograms_torch.fast.extrema import extrema_overrides
from configurable_spectrograms_torch.fast.plotting import (
    FAST_plot_instrument_grid,
    FAST_plot_pitch_angle_grid,
)
from configurable_spectrograms_torch.render.plotting import close_all_axes_and_clear
from configurable_spectrograms_torch.utils.logging import log_exception

# The reference runs ``gc.collect()`` after every orbit (reference
# fast/process_orbit.py:298) -- cheap there because each worker is a
# short-lived process with a small heap.  This engine renders in one
# long-lived process whose heap carries the resident caches, and the JAX
# package measured per-orbit full (gen-2) passes at 23% of a cold batch.
# Orbits therefore run a young-gen pass (frees the figure<->axes cycles
# while they are still young) and a full pass at most once per interval;
# ``CST_GC_FULL_INTERVAL_S=0`` restores the reference's every-orbit full
# collection.
_GC_FULL_INTERVAL_DEFAULT_S = 20.0
try:
    _GC_FULL_INTERVAL_S = float(
        os.environ.get("CST_GC_FULL_INTERVAL_S", str(_GC_FULL_INTERVAL_DEFAULT_S)) or 0.0
    )
except ValueError:
    _GC_FULL_INTERVAL_S = _GC_FULL_INTERVAL_DEFAULT_S
_GC_LAST_FULL = [0.0]


def _paced_gc() -> None:
    now = time.monotonic()
    if _GC_FULL_INTERVAL_S <= 0 or now - _GC_LAST_FULL[0] >= _GC_FULL_INTERVAL_S:
        _GC_LAST_FULL[0] = now
        gc.collect()
    else:
        gc.collect(1)


def _copy_saved_png(src: str, dst: str) -> None:
    """Duplicate an already-encoded PNG to a second target path.

    Used for given/raw filename pairs whose content is identical by
    construction.  The source is read into memory in one pass (the paced
    writeback queue may already have fsync'd and dropped its pages -- one
    bounded read either way), and the destination is written atomically
    via a unique ``.tmp-*`` sibling so a SIGKILL mid-copy never leaves a
    truncated PNG that the skip-existing resume would then preserve.  The
    copy joins the paced writeback queue like a real save.
    """
    import threading

    from configurable_spectrograms_torch.utils.writeback import note_written

    with open(src, "rb") as fh:
        data = fh.read()
    tmp = f"{dst}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, dst)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    note_written(dst)


class _OrbitRun:
    """Mutable state for one orbit's processing: result dict + timeouts."""

    def __init__(self, orbit: int, orbit_budget_s: float, stage_budget_s: float):
        self.result: dict[str, Any] = {"orbit": orbit, "status": "ok", "errors": []}
        self.started = time.time()
        self.orbit_budget_s = orbit_budget_s
        self.stage_budget_s = stage_budget_s
        self.timed_out = False

    def note_error(self, message: str, exc: BaseException | None = None) -> None:
        log_exception(message, exc, level="error")
        self.result["status"] = "error"
        self.result["errors"].append(message if exc is None else str(exc))

    def check_stage(self, stage_started: float, stage_name: str) -> None:
        """Soft per-stage timeout (reference fast/process_orbit.py:198-211)."""
        elapsed = time.time() - stage_started
        orbit = self.result["orbit"]
        log_exception(
            f"[TIMING] Orbit {orbit} instrument {stage_name} elapsed {elapsed:.3f}s"
            if stage_name != "instrument_grid"
            else f"[TIMING] Orbit {orbit} instrument-grid elapsed {elapsed:.3f}s",
            level="message",
        )
        if elapsed > self.stage_budget_s and not self.timed_out:
            self.timed_out = True
            self.result["timeout_type"] = "instrument"
            self.result["timeout_instrument"] = stage_name
            log_exception(
                f"[TIMEOUT] Instrument {stage_name} in orbit {orbit} exceeded "
                f"{self.stage_budget_s:.0f}s ({elapsed:.2f}s). Aborting.",
                level="message",
            )

    def check_orbit(self) -> None:
        elapsed = time.time() - self.started
        if elapsed > self.orbit_budget_s and not self.timed_out:
            self.timed_out = True
            self.result["timeout_type"] = "orbit"
            log_exception(
                f"[TIMEOUT] Orbit {self.result['orbit']} exceeded "
                f"{self.orbit_budget_s:.0f}s total ({elapsed:.2f}s).",
                level="message",
            )

    def finalize(self) -> dict[str, Any]:
        # A timeout outranks any per-figure errors (reference
        # fast/process_orbit.py:285-290); orbit-level timeouts carry no
        # timeout_instrument key.
        if self.timed_out:
            self.result["status"] = "timeout"
        return self.result


def FAST_process_single_orbit(
    orbit_number: int,
    instrument_file_paths: dict[str, str],
    filtered_orbits_dataframe,
    zoom_duration_minutes: float,
    y_axis_scale: str,
    z_axis_scale: str,
    instrument_order: tuple[str, ...],
    colormap: str,
    output_base_directory: str,
    orbit_timeout_seconds: int | float = 60,
    instrument_timeout_seconds: int | float = 30,
    global_extrema: dict[str, int | float] | None = None,
    override_plots: bool = True,
    cusp_marker_style: str = "both",
    cusp_marker_kwargs: dict | None = None,
) -> dict[str, Any]:
    """Render and save every figure for one orbit.

    Returns ``{orbit, status: ok|error|timeout, errors[], timeout_type?,
    timeout_instrument?}`` -- the schema the batch driver's progress
    taxonomy consumes (reference fast/process_orbit.py:85-92,285-290).
    Deterministic filenames make partial output from a timeout safe: a
    retry simply overwrites.
    """
    run = _OrbitRun(orbit_number, orbit_timeout_seconds, instrument_timeout_seconds)

    def save_batch(figs: list[tuple[Any, list[tuple[str, str]]]]) -> None:
        """Render a figure group in one pooled dispatch and write the PNGs.

        Each entry is ``(figure, [(out_path, desc), ...])``: a figure with
        several targets encodes ONCE and the later paths receive a byte
        copy of the first.  The per-orbit worker exploits this for the
        given/raw pairs whose resolved extrema are identical (the raw-args
        job, and instruments absent from the extrema dict): the reference
        renders the pair twice to byte-identical content
        (docs/parity.md "raw-args job writes given_extrema-named files";
        reference fast/process_orbit.py:148-190), so one render + one
        encode + one copy produces the exact same files at ~2/3 the cost.
        """
        from configurable_spectrograms_torch.render.figure import render_figures, save_image

        wanted = []
        for fig, targets in figs:
            remaining = []
            for out_path, desc in targets:
                if not override_plots and os.path.exists(out_path):
                    log_exception(f"[SKIP] Plot already exists, skipping: {out_path}", level="message")
                else:
                    remaining.append((out_path, desc))
            if remaining:
                wanted.append((fig, remaining))
            else:
                close_all_axes_and_clear(fig)
        if not wanted:
            return
        try:
            images = render_figures([f for f, _ in wanted], dpi=FAST_SAVE_DPI)
        except Exception as exc:
            run.note_error("[FAIL] Rendering figure batch", exc)
            for fig, _ in wanted:
                close_all_axes_and_clear(fig)
            return
        for (fig, targets), image in zip(wanted, images):
            written_first: str | None = None
            for out_path, desc in targets:
                try:
                    log_exception(
                        f"[DEBUG] Saving {desc} plot: y_axis_scale={y_axis_scale}, "
                        f"z_axis_scale={z_axis_scale}, filename={out_path}",
                        level="message",
                    )
                    if written_first is None:
                        save_image(image, out_path, compress_level=3)
                        written_first = out_path
                    else:
                        _copy_saved_png(written_first, out_path)
                    log_exception(f"[SAVED] {out_path}", level="message")
                except Exception as exc:
                    run.note_error(f"[FAIL] Saving figure {out_path}", exc)
            close_all_axes_and_clear(fig)

    try:
        first_path = next(
            (instrument_file_paths[k] for k in DEFAULT_INSTRUMENT_ORDER if k in instrument_file_paths),
            None,
        )
        year, month = parse_year_month(first_path) if first_path else ("unknown", "unknown")
        out_dir = os.path.join(output_base_directory, str(year), str(month), str(orbit_number))
        os.makedirs(out_dir, exist_ok=True)

        # --- per-instrument pitch-angle grids (given + raw variants) --------
        for inst in DEFAULT_INSTRUMENT_ORDER:
            if run.timed_out:
                break
            cdf_path = instrument_file_paths.get(inst)
            if not cdf_path:
                continue
            stage_t0 = time.time()
            try:
                detected = get_cdf_file_type(cdf_path)
                if detected in (None, "orb"):
                    continue
                marks = get_timestamps_for_orbit(
                    filtered_orbits_dataframe, orbit_number, detected,
                    load_fast_cdf_dataset(cdf_path)["times"],
                )
                cusp_tag = "_cusp" if marks else ""
                overrides = extrema_overrides(global_extrema, detected, y_axis_scale, z_axis_scale)

                variants = [
                    ("given_extrema", overrides),
                    ("raw", (None, None, None, None)),
                ]
                # All-None overrides (the raw-args job, or an instrument
                # absent from the extrema dict) make the two variants'
                # arguments identical, so their figures are byte-identical
                # by determinism: render once, write under both names.
                dedupe = overrides == (None, None, None, None)
                group = []
                for variant, (ymn, ymx, zmn, zmx) in variants:
                    name = (
                        f"{orbit_number}{cusp_tag}_pitch-angle_ESA_{detected}"
                        f"_y-{y_axis_scale}_z-{z_axis_scale}_{variant}-{colormap}.png"
                    )
                    target = (
                        os.path.join(out_dir, name),
                        f"pitch-angle {detected} ({variant.replace('_', ' ')})",
                    )
                    if dedupe and group:
                        group[0][1].append(target)
                        continue
                    fig, _ = FAST_plot_pitch_angle_grid(
                        cdf_path,
                        filtered_orbits_df=filtered_orbits_dataframe,
                        orbit_number=orbit_number,
                        zoom_duration_minutes=zoom_duration_minutes,
                        scale_function_y=y_axis_scale,
                        scale_function_z=z_axis_scale,
                        show=False,
                        colormap=colormap,
                        y_min=ymn,
                        y_max=ymx,
                        z_min=zmn,
                        z_max=zmx,
                        cusp_marker_style=cusp_marker_style,
                        cusp_marker_kwargs=cusp_marker_kwargs,
                    )
                    if fig is not None:
                        group.append((fig, [target]))
                save_batch(group)
            except Exception as exc:
                run.note_error(f"[FAIL] Plotting Orbit {orbit_number} pitch angle grid for {inst}", exc)
            finally:
                run.check_stage(stage_t0, inst)

        # --- instrument grids (given + raw variants) --------------------------
        if not run.timed_out:
            stage_t0 = time.time()
            try:
                # The raw-args job passes global_extrema=None: both
                # variants' arguments are identical, so render once and
                # write under both names (byte-identical by determinism).
                dedupe = global_extrema is None
                group = []
                for variant, extrema in (("given_extrema", global_extrema), ("raw", None)):
                    name = (
                        f"{orbit_number}_instrument-grid_ESA_y-{y_axis_scale}"
                        f"_z-{z_axis_scale}_{variant}-{colormap}.png"
                    )
                    target = (os.path.join(out_dir, name), f"instrument-grid ({variant})")
                    if dedupe and group:
                        group[0][1].append(target)
                        continue
                    fig, _ = FAST_plot_instrument_grid(
                        instrument_file_paths,
                        filtered_orbits_df=filtered_orbits_dataframe,
                        orbit_number=orbit_number,
                        zoom_duration_minutes=zoom_duration_minutes,
                        scale_function_y=y_axis_scale,
                        scale_function_z=z_axis_scale,
                        instrument_order=instrument_order,
                        show=False,
                        colormap=colormap,
                        global_extrema=extrema,
                        cusp_marker_style=cusp_marker_style,
                        cusp_marker_kwargs=cusp_marker_kwargs,
                    )
                    if fig is not None:
                        group.append((fig, [target]))
                save_batch(group)
            except Exception as exc:
                run.note_error(f"[FAIL] Plotting Orbit {orbit_number} instrument grid", exc)
            finally:
                run.check_stage(stage_t0, "instrument_grid")

        run.check_orbit()
    except Exception as exc:
        run.note_error(f"[FAIL] Orbit {orbit_number} processing", exc)
    finally:
        _paced_gc()

    return run.finalize()
