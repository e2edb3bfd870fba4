"""The generators: one seed gives the same bytes, another seed others, in the documented layout."""

from __future__ import annotations

import hashlib

import numpy as np
from bench_helpers import traffic

from gen import audio as gen_audio
from gen import fast_archive


def _digests(root) -> dict[str, str]:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*.cdf"))}


def test_archive_is_the_same_for_a_seed_and_differs_across_seeds(tmp_path):
    t = traffic("fast_esa_l2.sample_orbits")
    fast_archive.write_archive(str(tmp_path / "a"), 3000000001, t, 2)
    fast_archive.write_archive(str(tmp_path / "b"), 3000000001, t, 2)
    fast_archive.write_archive(str(tmp_path / "c"), 3000000002, t, 2)
    a, b, c = (_digests(tmp_path / k) for k in "abc")
    assert len(a) == 4 and a == b
    assert all(a[name] != c[name] for name in a)


def test_archive_layout_as_documented(tmp_path):
    """(T, 64, 96) data and pitch angles, (records, angles, 96) energies, blocks of 2048 records."""
    from configurable_spectrograms_torch.data.cdf import CDF
    from configurable_spectrograms_torch.data.cdf_utils import get_timestamps_for_orbit, load_filtered_orbits

    t = traffic("fast_esa_l2.sample_orbits", n_time={"ees": 4100, "ies": 800, "eeb": 903, "ieb": 48})
    archive = fast_archive.write_archive(str(tmp_path), 7, t, 4)
    assert len(archive["files"]) == 4
    frame = load_filtered_orbits(archive["cusp_csv"])
    for path in archive["files"]:
        inst = next(i for i in fast_archive.INSTRUMENTS if f"_{i}_" in path)
        T = t["n_time"][inst]
        with CDF(path) as f:
            data = np.asarray(f.varget("data"))
            assert data.shape == (T, 64, 96) and data.dtype == np.float32
            assert np.asarray(f.varget("pitch_angle")).shape == (T, 64, 96)
            assert np.asarray(f.varget("energy")).shape == (*t["energy_shape"][inst], 96)
            times = np.asarray(f.varget("time_unix"))
        ref = fast_archive.instrument_arrays(7, 13616, inst, **fast_archive.instrument_shape(t, inst))
        assert np.array_equal(data, ref["data"], equal_nan=True)
        assert 0.01 < np.isnan(data).mean() < 0.03
        lo, hi = fast_archive.cusp_rows(T)
        assert get_timestamps_for_orbit(frame, 13616, inst, times) == [float(times[lo]), float(times[hi])]


def test_recordings_repeat_for_a_seed(tmp_path):
    a = gen_audio.write_recordings(str(tmp_path), 11, 2, 3.0, 8000, 2)
    first = [open(p, "rb").read() for p in a]
    again = gen_audio.recording(11, 1, 3.0, 8000)
    assert first[0] != first[1]
    assert np.array_equal(np.frombuffer(first[1][44:], "<i2"), again)
    assert again.dtype == np.int16 and again.size == 24000
