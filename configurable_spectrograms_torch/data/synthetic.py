"""Synthetic FAST ESA CDF fixture generation.

The reference repo ships no CDF data, and its baseline must be measured on
synthetic inputs (SURVEY.md section 6), so this module generates
structurally-faithful FAST ESA L2 instrument files:

* variables ``time_unix`` (T,), ``data`` (T, A, E), ``energy`` (T, A, E)
  with the per-bin energies broadcast across time/angle, ``pitch_angle``
  (T, A, E) likewise -- matching the layout documented in the reference's
  ``FAST CDF variables.txt`` (angle dim 32 or 64, energy dim 48 or 96,
  time dim varying per orbit; shipped verbatim at the repo root alongside
  ``FAST_Cusp_Indices.csv`` -- it is mission data, like the cusp CSV) and
  consumed by ``load_fast_cdf_dataset``.
* descending energy bins (FAST ESA sweeps high->low), NaN fill regions,
  and a cusp-like enhancement so percentile color bounds are exercised.
* FAST CDAWeb-style file names
  ``fa_esa_l2_{inst}_{YYYYMMDDhhmmss}_{orbit}_v02.cdf`` under
  ``{root}/{year}/{month}/`` so orbit discovery walks them identically.
* an accompanying cusp-indices TSV compatible with
  :func:`configurable_spectrograms_torch.data.cdf_utils.load_filtered_orbits`.
"""

from __future__ import annotations

import datetime as dt
import os

import numpy as np

from configurable_spectrograms_torch.data.cdf.writer import write_cdf
from configurable_spectrograms_torch.data.orbit_discovery import DEFAULT_INSTRUMENT_ORDER

#: FAST orbital period is ~133 minutes; synthetic orbits reuse that cadence.
ORBIT_PERIOD_SECONDS = 133 * 60.0


def synth_instrument_arrays(
    rng: np.random.Generator,
    n_time: int,
    n_angle: int = 32,
    n_energy: int = 48,
    t0: float = 946684800.0,
    duration: float = 1200.0,
    cusp_frac: tuple[float, float] | None = (0.45, 0.55),
    nan_frac: float = 0.02,
) -> dict[str, np.ndarray]:
    """Generate one instrument's worth of FAST-shaped arrays.

    Returns a dict with keys ``time_unix``, ``data``, ``energy``,
    ``pitch_angle`` in the raw (time, angle, energy) storage layout.
    """
    times = np.linspace(t0, t0 + duration, n_time)
    energy_bins = np.geomspace(30000.0, 4.0, n_energy).astype(np.float32)  # descending
    pitch_bins = np.linspace(0.0, 360.0, n_angle, endpoint=False).astype(np.float32)

    tt = np.linspace(0, 1, n_time)[:, None, None]
    pa = pitch_bins[None, :, None] * np.pi / 180.0
    en = np.log10(energy_bins[None, None, :])

    # Smooth background: field-aligned (cos pitch) population peaking at low
    # energies, plus Poisson-ish noise.
    background = 40.0 * np.exp(-((en - 1.2) ** 2) / 0.8) * (1.0 + 0.5 * np.cos(pa)) * (0.8 + 0.4 * np.sin(6.28 * tt))
    data = rng.poisson(np.maximum(background, 0.01)).astype(np.float32)

    if cusp_frac is not None:
        lo, hi = cusp_frac
        in_cusp = (tt >= lo) & (tt <= hi)
        cusp = 400.0 * np.exp(-((en - 2.5) ** 2) / 0.3) * (1.0 + np.cos(pa))
        data = data + np.where(in_cusp, rng.poisson(np.maximum(cusp, 0.01)).astype(np.float32), 0.0)

    if nan_frac > 0:
        mask = rng.random(data.shape) < nan_frac
        data = np.where(mask, np.nan, data)

    energy_full = np.broadcast_to(energy_bins[None, None, :], data.shape).astype(np.float32).copy()
    pitch_full = np.broadcast_to(pitch_bins[None, :, None], data.shape).astype(np.float32).copy()
    return {
        "time_unix": times.astype(np.float64),
        "data": data.astype(np.float32),
        "energy": energy_full,
        "pitch_angle": pitch_full,
    }


def synth_fast_cdf(
    path: str,
    orbit: int,
    instrument: str,
    n_time: int = 396,
    n_angle: int = 32,
    n_energy: int = 48,
    t0: float | None = None,
    seed: int | None = None,
    compress: str = "gzip",
) -> str:
    """Write one synthetic FAST instrument CDF to *path*."""
    # sum(ord) rather than hash(): str hashing is randomized per process,
    # which would make default-seed fixtures non-reproducible across runs.
    rng = np.random.default_rng(
        seed if seed is not None else orbit * 131 + sum(instrument.encode()) % 1000
    )
    if t0 is None:
        t0 = 946684800.0 + orbit * ORBIT_PERIOD_SECONDS
    arrays = synth_instrument_arrays(rng, n_time=n_time, n_angle=n_angle, n_energy=n_energy, t0=t0)
    return write_cdf(
        path,
        arrays,
        global_attrs={
            "Project": "FAST (synthetic fixture)",
            "Descriptor": f"ESA {instrument.upper()}",
            "Logical_source": f"fa_esa_l2_{instrument}",
        },
        compress=compress,
    )


def synth_fast_archive(
    root: str,
    orbits: list[int],
    instruments: tuple[str, ...] = DEFAULT_INSTRUMENT_ORDER,
    n_time: int = 396,
    n_angle: int = 32,
    n_energy: int = 48,
    base_epoch: float = 946684800.0,
    seed: int = 0,
    compress: str = "gzip",
    cusp_csv_path: str | None = None,
) -> dict[int, dict[str, str]]:
    """Write a synthetic multi-orbit FAST archive under *root*.

    Files follow the CDAWeb name/layout scheme so
    :func:`discover_orbit_files` groups them exactly as real data.  When
    *cusp_csv_path* is given, a matching cusp-indices TSV is written with
    a marked interval for every orbit.

    Returns ``{orbit: {instrument: path}}``.
    """
    out: dict[int, dict[str, str]] = {}
    cusp_rows = []
    for k, orbit in enumerate(orbits):
        t0 = base_epoch + orbit * ORBIT_PERIOD_SECONDS
        date = dt.datetime.fromtimestamp(t0, tz=dt.timezone.utc)
        year, month = f"{date.year:04d}", f"{date.month:02d}"
        folder = os.path.join(root, year, month)
        os.makedirs(folder, exist_ok=True)
        stamp = date.strftime("%Y%m%d%H%M%S")
        paths: dict[str, str] = {}
        for inst in instruments:
            fname = f"fa_esa_l2_{inst}_{stamp}_{orbit}_v02.cdf"
            path = os.path.join(folder, fname)
            synth_fast_cdf(
                path,
                orbit,
                inst,
                n_time=n_time,
                n_angle=n_angle,
                n_energy=n_energy,
                t0=t0,
                # Instruments beyond the default four (e.g. esv) mix the
                # orbit and name in too -- a bare `seed` fallback wrote
                # bit-identical cubes for every orbit of such instruments.
                seed=seed * 100003 + orbit * 131 + (
                    DEFAULT_INSTRUMENT_ORDER.index(inst)
                    if inst in DEFAULT_INSTRUMENT_ORDER
                    else len(DEFAULT_INSTRUMENT_ORDER) + sum(inst.encode()) % 997
                ),
                compress=compress,
            )
            paths[inst] = path
        out[orbit] = paths
        # Cusp interval = middle ~10% of the record (matches synth cusp_frac).
        lo_idx, hi_idx = int(n_time * 0.45), int(n_time * 0.55)
        row: dict[str, object] = {"Orbit Number": orbit, "Folder Path": folder}
        for inst in instruments:
            row[f"{inst} present"] = 1
            row[f"{inst} File"] = os.path.basename(paths[inst])
            row[f"{inst} min Index"] = lo_idx
            row[f"{inst} Max Index"] = hi_idx
        cusp_rows.append(row)

    if cusp_csv_path is not None and cusp_rows:
        import pandas as pd

        pd.DataFrame(cusp_rows).to_csv(cusp_csv_path, sep="\t", index=False)
    return out
