"""Seeded FAST ESA L2 archives in the documented layout, written by child processes.

One file per orbit and instrument, named and laid out as CDAWeb serves
them (``{root}/{YYYY}/{MM}/fa_esa_l2_{inst}_{stamp}_{orbit}_v02.cdf``),
with the variables of the reference's ``FAST CDF variables.txt``:
``time_unix`` (T,), ``data`` and ``pitch_angle`` (T, 64, 96) float32 and
``energy`` (records, angles, 96) float32 (2 or 3 sweep records; 32 angles
for the burst instruments).  The values follow
``configurable_spectrograms_torch/data/synthetic.py``'s layout: Poisson
counts around a field-aligned background, descending energy bins, a cusp
enhancement over the middle tenth of the record and 2% NaN fill.  Every
orbit is a cusp orbit, and the cusp-index table lists it.  The same seed,
orbit and instrument always give the same arrays; the reference makes
them again from those three numbers.
"""

from __future__ import annotations

import csv
import datetime as dt
import os

import numpy as np

INSTRUMENTS = ("ees", "eeb", "ies", "ieb")
ORBIT_PERIOD_S = 133 * 60.0
EPOCH_S = 946684800.0  # 2000-01-01
CUSP = (0.45, 0.55)  # the cusp's share of the record


BLOCK_RECORDS = 2048  # records in one compressed block of a variable, and in one generator task


def blocks(n_time: int) -> list[tuple[int, int]]:
    """The [start, stop) record ranges of a file's blocks."""
    return [(r, min(r + BLOCK_RECORDS, n_time)) for r in range(0, n_time, BLOCK_RECORDS)]


def _axes(n_time: int, n_angle: int, n_energy: int):
    tt = np.linspace(0.0, 1.0, n_time)
    energy = np.geomspace(30000.0, 4.0, n_energy).astype(np.float32)  # FAST ESA sweeps high to low
    pitch = np.linspace(0.0, 360.0, n_angle, endpoint=False).astype(np.float32)
    return tt, energy, pitch


def data_block(seed: int, orbit: int, inst: str, n_time: int, n_angle: int, n_energy: int, nan_frac: float,
               start: int, stop: int, **_) -> np.ndarray:
    """Records [start, stop) of the ``data`` variable, from (seed, orbit, instrument, block) alone."""
    rng = np.random.default_rng([seed % 2**63, orbit, INSTRUMENTS.index(inst), start // BLOCK_RECORDS])
    tt, energy, pitch = _axes(n_time, n_angle, n_energy)
    tt = tt[start:stop]
    en = np.log10(energy.astype(np.float64))
    pa = pitch.astype(np.float64) * np.pi / 180.0
    spectrum = (40.0 * np.exp(-((en - 1.2) ** 2) / 0.8))[None, :] * (1.0 + 0.5 * np.cos(pa))[:, None]
    level = 0.8 + 0.4 * np.sin(6.28 * tt)
    lam = np.maximum(level[:, None, None] * spectrum[None], 0.01).astype(np.float32)
    data = rng.poisson(lam).astype(np.float32)
    del lam
    rows = (tt >= CUSP[0]) & (tt <= CUSP[1])
    cusp = np.maximum(400.0 * np.exp(-((en - 2.5) ** 2) / 0.3)[None, :] * (1.0 + np.cos(pa))[:, None], 0.01)
    data[rows] += rng.poisson(cusp, size=(int(rows.sum()), n_angle, n_energy)).astype(np.float32)
    data[rng.random(data.shape, dtype=np.float32) < nan_frac] = np.nan
    return data


def instrument_arrays(seed: int, orbit: int, inst: str, n_time: int, n_angle: int, n_energy: int,
                      energy_shape: tuple[int, int], duration_s: float,
                      nan_frac: float) -> dict[str, np.ndarray]:
    """One instrument file's variables, whole (the reference's view of the file)."""
    tt, energy, pitch = _axes(n_time, n_angle, n_energy)
    data = np.concatenate([data_block(seed, orbit, inst, n_time, n_angle, n_energy, nan_frac, a, b)
                           for a, b in blocks(n_time)])
    return {
        "time_unix": EPOCH_S + orbit * ORBIT_PERIOD_S + tt * duration_s,
        "data": data,
        "energy": np.broadcast_to(energy[None, None, :], (*energy_shape, n_energy)),
        "pitch_angle": np.broadcast_to(pitch[None, :, None], (n_time, n_angle, n_energy)),
    }


def cusp_rows(n_time: int) -> tuple[int, int]:
    """The cusp-index table's (min, max) row of a record of *n_time* rows."""
    return int(n_time * CUSP[0]), int(n_time * CUSP[1])


def orbit_folder(orbit: int) -> tuple[str, str, str]:
    """(year, month, stamp) of an orbit's files."""
    date = dt.datetime.fromtimestamp(EPOCH_S + orbit * ORBIT_PERIOD_S, tz=dt.timezone.utc)
    return f"{date.year:04d}", f"{date.month:02d}", date.strftime("%Y%m%d%H%M%S")


def file_name(orbit: int, inst: str) -> str:
    return f"fa_esa_l2_{inst}_{orbit_folder(orbit)[2]}_{orbit}_v02.cdf"


def compress_block(task: tuple) -> tuple[tuple, int, int, bytes, bytes]:
    """Child process: one block of a file's ``data`` and ``pitch_angle`` records, compressed."""
    from gen.cdf_writer import compress

    seed, orbit, inst, shape, start, stop, level = task
    data = data_block(seed, orbit, inst, start=start, stop=stop, **shape)
    _, _, pitch = _axes(shape["n_time"], shape["n_angle"], shape["n_energy"])
    pitch_rows = np.broadcast_to(pitch[None, :, None], (stop - start, shape["n_angle"], shape["n_energy"]))
    return (orbit, inst), start, stop, compress(data, level), compress(pitch_rows, level)


def write_file(root: str, orbit: int, inst: str, shape: dict, duration_s: float, parts: list, level: int) -> tuple:
    """Assemble one file from its compressed blocks; (path, bytes)."""
    from gen.cdf_writer import Blocks, write_cdf

    tt, energy, _ = _axes(shape["n_time"], shape["n_angle"], shape["n_energy"])
    T, A, E = shape["n_time"], shape["n_angle"], shape["n_energy"]
    parts = sorted(parts)
    year, month, _ = orbit_folder(orbit)
    path = os.path.join(root, year, month, file_name(orbit, inst))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    variables = {
        "time_unix": EPOCH_S + orbit * ORBIT_PERIOD_S + tt * duration_s,
        "data": Blocks("float32", (T, A, E), [(a, b - 1, d) for a, b, d, _ in parts]),
        "energy": np.broadcast_to(energy[None, None, :], (*shape["energy_shape"], E)),
        "pitch_angle": Blocks("float32", (T, A, E), [(a, b - 1, p) for a, b, _, p in parts]),
    }
    attrs = {"Project": "FAST (benchmark archive)", "Descriptor": f"ESA {inst.upper()}",
             "Logical_source": f"fa_esa_l2_{inst}"}
    return path, write_cdf(path, variables, attrs, level=level)


def instrument_shape(traffic: dict, inst: str) -> dict:
    """The keyword arguments of :func:`instrument_arrays` for *inst* under a traffic mix."""
    return {"n_time": int(traffic["n_time"][inst]), "n_angle": int(traffic["n_angle"]),
            "n_energy": int(traffic["n_energy"]), "energy_shape": tuple(traffic["energy_shape"][inst]),
            "duration_s": float(traffic["duration_s"]), "nan_frac": float(traffic["nan_frac"])}


def orbits(traffic: dict) -> list[int]:
    return [int(traffic["first_orbit"]) + k for k in range(int(traffic["orbits"]))]


def write_archive(root: str, seed: int, traffic: dict, workers: int) -> dict:
    """Every file of the archive, its blocks made by *workers* spawned children; the cusp table beside it.

    Returns ``{"files": [...], "bytes": n, "cusp_csv": path}``.
    """
    import concurrent.futures
    import multiprocessing

    level = int(traffic["deflate_level"])
    shapes = {inst: instrument_shape(traffic, inst) for inst in INSTRUMENTS}
    tasks = [(seed, orbit, inst, shapes[inst], a, b, level) for orbit in orbits(traffic) for inst in INSTRUMENTS
             for a, b in blocks(shapes[inst]["n_time"])]
    parts: dict[tuple, list] = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=min(workers, len(tasks)), mp_context=ctx) as pool:
        for key, a, b, data, pitch in pool.map(compress_block, tasks):
            parts.setdefault(key, []).append((a, b, data, pitch))
    written = [write_file(root, orbit, inst, shapes[inst], float(traffic["duration_s"]), parts[(orbit, inst)],
                          level) for orbit, inst in sorted(parts)]
    cusp_csv = os.path.join(root, "FAST_Cusp_Indices.csv")
    write_cusp_table(cusp_csv, traffic)
    return {"files": [w[0] for w in written], "bytes": sum(w[1] for w in written), "cusp_csv": cusp_csv}


def write_cusp_table(path: str, traffic: dict) -> None:
    """The cusp-index table (tab-separated) with every orbit's interval, as the flagship CLI reads it."""
    header = ["Orbit Number", "Folder Path"]
    for inst in INSTRUMENTS:
        header += [f"{inst} present", f"{inst} File", f"{inst} min Index", f"{inst} Max Index"]
    with open(path, "w", newline="") as f:
        out = csv.writer(f, delimiter="\t")
        out.writerow(header)
        for orbit in orbits(traffic):
            year, month, _ = orbit_folder(orbit)
            row = [orbit, f"./FAST_data/{year}/{month}"]
            for inst in INSTRUMENTS:
                lo, hi = cusp_rows(int(traffic["n_time"][inst]))
                row += [1, file_name(orbit, inst), lo, hi]
            out.writerow(row)


def link_archive(files: list[str], src_root: str, dest: str) -> None:
    """Hard links to the archive's files under *dest*, keeping their year/month folders."""
    for path in files:
        target = os.path.join(dest, os.path.relpath(path, src_root))
        os.makedirs(os.path.dirname(target), exist_ok=True)
        os.link(path, target)
