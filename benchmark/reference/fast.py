"""The flagship batch's results worked out again from the generator's arrays.

What the reference ``batch_multi_plot_FAST_spectrograms.py`` defines for
an archive (its four scale combos, each orbit's ten PNGs, the 99th
percentile extrema pre-pass with its JSON keys, and each figure's panels)
in plain numpy, from :mod:`gen.fast_archive`'s arrays.  Nothing here
imports the port.

The batch submits every orbit twice per combo, once without extrema and
once with them, and skips a file that exists: a ``given_extrema``-named
PNG holds the given-extrema figure or, where the job without extrema wrote
it first (or the given figure has no panel, as on a log energy axis), the
figure without extrema.  :func:`expected_figures` lists both.
"""

from __future__ import annotations

import math
import os

import numpy as np

from gen import fast_archive
from reference import panel
from reference.judge import Figure

COMBOS = (("linear", "linear", "viridis"), ("linear", "log", "cividis"),
          ("log", "linear", "plasma"), ("log", "log", "inferno"))
#: The pitch-angle categories, in the rows' order, with their inclusive degree ranges.
CATEGORIES = (((0.0, 360.0),), ((0.0, 30.0), (330.0, 360.0)), ((150.0, 210.0),),
              ((40.0, 140.0), (210.0, 330.0)))
CATEGORY_LABEL_LINES = 2  # "Downgoing\n(0, 30), (330, 360)": the row labels' line count
ZOOM_MINUTES = 6.0
MAX_PERCENTILE = 99.0
ENERGY_CAP = 4000
LOG_FLOOR = (0.1, -1.0)  # (cutoff, value) of the log of a cached extremum
DPI = 200
FIGURE_PANELS = 8  # a grid of 4 rows x (full, zoomed)


def file_summary(task: tuple) -> dict:
    """Child process: one file's arrays made again, reduced to what the reference needs.

    *task* is (seed, orbit, instrument, shape, collapse): the last is the
    pitch-angle sum (:func:`reference.panel.collapse`; the control passes
    its own).
    """
    seed, orbit, inst, shape, collapse = task
    arrays = fast_archive.instrument_arrays(seed, orbit, inst, **shape)
    cube = arrays["data"]
    energy = np.ascontiguousarray(arrays["energy"][0, 0, :])
    pitch = np.ascontiguousarray(arrays["pitch_angle"][0, :, 0])
    mats = []
    for ranges in CATEGORIES:
        mask = np.zeros(pitch.shape, bool)
        for lo, hi in ranges:
            mask |= (pitch >= lo) & (pitch <= hi)
        mats.append(collapse(cube, mask))
    return {"orbit": orbit, "inst": inst, "times": arrays["time_unix"], "energy": energy, "mats": mats,
            "cusp": fast_archive.cusp_rows(shape["n_time"])}


def summaries(seed: int, traffic: dict, workers: int, collapse=panel.collapse) -> dict[tuple[int, str], dict]:
    """(orbit, instrument) -> :func:`file_summary`, made in *workers* spawned children."""
    import concurrent.futures
    import multiprocessing

    tasks = [(seed, orbit, inst, fast_archive.instrument_shape(traffic, inst), collapse)
             for orbit in fast_archive.orbits(traffic) for inst in fast_archive.INSTRUMENTS]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=min(workers, len(tasks)), mp_context=ctx) as pool:
        return {(s["orbit"], s["inst"]): s for s in pool.map(file_summary, tasks)}


def _safe_log(value) -> float:
    cutoff, floor = LOG_FLOOR
    v = float(value)
    return floor if (not np.isfinite(v) or v <= cutoff) else float(np.log10(v))


def extrema(files: dict[tuple[int, str], dict]) -> dict[str, float]:
    """The extrema JSON's value keys ``{inst}_{y}_{z}_{y|z}_{min|max}`` for the four combos.

    Per instrument, orbit by orbit: the energy at which the pitch-summed
    matrix's positive cells reach 99% of their count, and the 99th
    percentile of all positive cells so far; each the running maximum,
    ceiled, the energy capped at 4000.  The log combos take log10 of the
    linear values with the floor at 0.1 -> -1.
    """
    out: dict[str, float] = {}
    orbit_list = sorted({o for o, _ in files})
    for inst in fast_archive.INSTRUMENTS:
        counts: dict[float, int] = {}
        pools: list[np.ndarray] = []
        y_max = z_max = None
        for orbit in orbit_list:
            s = files[(orbit, inst)]
            m = s["mats"][0]
            pos = np.isfinite(m) & (m > 0)
            for e, c in zip(s["energy"], pos.sum(axis=0)):
                if c:
                    counts[float(e)] = counts.get(float(e), 0) + int(c)
            pools.append(m[pos])
            es = sorted(counts)
            cum = np.cumsum([counts[e] for e in es])
            cand_e = float(es[min(int(np.searchsorted(cum, 0.99 * cum[-1], side="right")), len(es) - 1)])
            cand_z = float(np.percentile(np.concatenate(pools), MAX_PERCENTILE))
            y_max = int(min(ENERGY_CAP, math.ceil(cand_e if y_max is None else max(y_max, cand_e))))
            z_max = float(math.ceil(cand_z if z_max is None else max(z_max, cand_z)))
        for y_scale, z_scale, _ in COMBOS:
            p = f"{inst}_{y_scale}_{z_scale}"
            out[f"{p}_y_min"] = LOG_FLOOR[1] if y_scale == "log" else 0
            out[f"{p}_y_max"] = _safe_log(y_max) if y_scale == "log" else y_max
            out[f"{p}_z_min"] = LOG_FLOOR[1] if z_scale == "log" else 0
            out[f"{p}_z_max"] = _safe_log(z_max) if z_scale == "log" else z_max
    return out


def round_extremum(value: float, direction: str) -> float:
    """One significant digit below the leading one, up or down: 1234 -> 1300 / 1200."""
    if value == 0:
        return 0.0
    scale = 10.0 ** (math.floor(math.log10(abs(value))) - 1)
    return float((math.ceil if direction == "up" else math.floor)(value / scale) * scale)


def _marks(s: dict) -> list[float]:
    lo, hi = s["cusp"]
    top = len(s["times"]) - 1
    lo, hi = min(max(lo, 0), top), min(max(hi, 0), top)
    return [float(s["times"][lo])] if lo == hi else [float(s["times"][lo]), float(s["times"][hi])]


def _columns(times: np.ndarray, marks: list[float]) -> list[tuple[panel.Window, list[float]]]:
    """The full and zoomed columns' windows, each with the cusp marks drawn inside it."""
    if len(marks) == 1:
        center, duration = marks[0], ZOOM_MINUTES * 60
    else:
        center = 0.5 * (marks[0] + marks[1])
        duration = max(ZOOM_MINUTES * 60, abs(marks[1] - marks[0]) * 1.5)
    cols = []
    for w in (panel.time_window(times, x_min=times[0], x_max=times[-1]),
              panel.time_window(times, center=center, duration=duration)):
        sel = times[w.t_start : w.t_start + w.t_count]
        cols.append((w, [v for v in marks if sel[0] <= v <= sel[-1]]))
    return cols


def _row(s: dict, mat: np.ndarray, columns, z_bounds, bounds_range, z_scale: str) -> list[dict]:
    return [{"matrix": mat, "energy": s["energy"], "y_range": (0, 4000), "window": w, "marks": marks,
             "z_bounds": z_bounds, "bounds_range": bounds_range, "z_scale": z_scale} for w, marks in columns]


def pitch_figure(s: dict, combo: tuple, ext: dict | None) -> Figure | None:
    """One instrument file's pitch-angle grid; *ext* the extrema JSON (None: the job without extrema)."""
    y_scale, z_scale, cmap = combo
    p = f"{s['inst']}_{y_scale}_{z_scale}"
    if ext is None:
        y_range, z_bounds = (0, 4000), (None, None)
    else:
        y_range = (round_extremum(ext[f"{p}_y_min"], "down"), round_extremum(ext[f"{p}_y_max"], "up"))
        z_bounds = (round_extremum(ext[f"{p}_z_min"], "down"), round_extremum(ext[f"{p}_z_max"], "up"))
    if not np.any((s["energy"] >= y_range[0]) & (s["energy"] <= y_range[1])):
        return None
    columns = _columns(s["times"], _marks(s))
    rows = [_row(s, mat, columns, z_bounds, y_range, z_scale) for mat in s["mats"]]
    return Figure(f"Orbit {s['orbit']} - Pitch Angle {s['inst']} ESA Spectrograms", rows, y_scale, cmap,
                  figsize=(24, 12), dpi=DPI, bottom_reserve=0.18, label_lines=CATEGORY_LABEL_LINES)


def instrument_figure(orbit_files: list[dict], combo: tuple, ext: dict | None) -> Figure | None:
    """One orbit's instrument grid: a row per instrument, the marks of the first."""
    y_scale, z_scale, cmap = combo
    rows, marks = [], None
    for s in orbit_files:
        p = f"{s['inst']}_{y_scale}_{z_scale}"
        if marks is None:
            marks = _marks(s)
        if ext is None:
            y_range, z_bounds = (0, 4000), (None, None)
        else:
            y_range = (ext[f"{p}_y_min"], ext[f"{p}_y_max"])
            z_bounds = (ext[f"{p}_z_min"], ext[f"{p}_z_max"])
        if not np.any((s["energy"] >= y_range[0]) & (s["energy"] <= y_range[1])):
            continue
        cols = _columns(s["times"], marks)
        rows.append(_row(s, s["mats"][0], cols, z_bounds, y_range, z_scale))
    if not rows:
        return None
    return Figure(f"Orbit {orbit_files[0]['orbit']} -  ESA Spectrograms", rows, y_scale, cmap,
                  figsize=(24, 3 * len(rows)), dpi=DPI, bottom_reserve=0.18, label_lines=1)


def expected_figures(files: dict[tuple[int, str], dict], ext: dict) -> dict[str, list[Figure]]:
    """Relative PNG path under ``FAST_plots/`` -> the figures its content may be (best match judged)."""
    out: dict[str, list[Figure]] = {}
    for orbit in sorted({o for o, _ in files}):
        year, month, _ = fast_archive.orbit_folder(orbit)
        base = os.path.join(year, month, str(orbit))
        for combo in COMBOS:
            y_scale, z_scale, cmap = combo
            for inst in fast_archive.INSTRUMENTS:
                s = files[(orbit, inst)]
                raw = pitch_figure(s, combo, None)
                given = pitch_figure(s, combo, ext)
                stem = f"{orbit}_cusp_pitch-angle_ESA_{inst}_y-{y_scale}_z-{z_scale}"
                out[os.path.join(base, f"{stem}_raw-{cmap}.png")] = [raw]
                out[os.path.join(base, f"{stem}_given_extrema-{cmap}.png")] = [f for f in (given, raw) if f]
            row_files = [files[(orbit, inst)] for inst in fast_archive.INSTRUMENTS]
            raw = instrument_figure(row_files, combo, None)
            given = instrument_figure(row_files, combo, ext)
            stem = f"{orbit}_instrument-grid_ESA_y-{y_scale}_z-{z_scale}"
            out[os.path.join(base, f"{stem}_raw-{cmap}.png")] = [raw]
            out[os.path.join(base, f"{stem}_given_extrema-{cmap}.png")] = [f for f in (given, raw) if f]
    return out
