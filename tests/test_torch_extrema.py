"""The port's extrema pre-pass against the JAX package.

Per-file statistics go through ``ops.extrema_ops`` of both packages and the
numpy mirror; the folder-wide pass writes its JSON cache in both packages,
and the two caches must agree key by key, bit for bit
(docs/parity.md:137-146), so either drives the other's given-extrema
render.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from configurable_spectrograms_torch.ops import extrema_ops as X  # noqa: E402

torch.set_num_threads(1)


def _cube(seed, T=60, A=12, E=20):
    rng = np.random.default_rng(seed)
    cube = (rng.random((T, A, E)) * 10.0 ** rng.uniform(-3, 6)).astype(np.float32)
    cube[rng.random(cube.shape) < 0.15] = np.nan
    cube[rng.random(cube.shape) < 0.05] *= -1.0
    cube[3, 2, 4] = np.inf
    return cube


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_file_extrema_stats_matches_jax_and_host(seed):
    from configurable_spectrograms_tpu.ops.extrema_ops import file_extrema_stats

    cube = _cube(seed)
    got = X.file_extrema_stats(torch.from_numpy(cube), cube.shape[0])
    ref = file_extrema_stats(jnp.asarray(cube), cube.shape[0])
    host = X.host_file_stats(cube)
    for k in ("counts", "hist"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=f"{k} vs JAX")
        np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=f"{k} vs host")


def test_batched_file_stats_pads_mixed_shapes(monkeypatch):
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    cubes = [_cube(5, 40, 8, 16), _cube(6, 60, 12, 20), _cube(7, 30, 12, 9)]
    got = X.batched_file_stats(cubes)
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    host = X.batched_file_stats(cubes)
    assert len(got) == 3
    for g, h, c in zip(got, host, cubes):
        assert g["counts"].shape == (c.shape[2],)
        np.testing.assert_array_equal(g["counts"], h["counts"])
        np.testing.assert_array_equal(g["hist"], h["hist"])


def test_numpy_half_is_the_reference_code():
    from configurable_spectrograms_tpu.ops import extrema_ops as ref

    cube = _cube(9)
    np.testing.assert_array_equal(X.collapsed_positives(cube), ref.collapsed_positives(cube))
    vals = X.collapsed_positives(cube)
    np.testing.assert_array_equal(X.value_bins(vals), ref.value_bins(vals))
    hist = X.host_file_stats(cube)["hist"]
    for q in (1.0, 50.0, 95.0):
        assert X.hist_percentile(hist, q) == ref.hist_percentile(hist, q)


@pytest.fixture(scope="module")
def small_archive(tmp_path_factory):
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("torch_extrema")
    mapping = synth_fast_archive(str(root / "data"), [300, 301, 302], n_time=80, n_angle=16, n_energy=24,
                                 cusp_csv_path=str(root / "cusp.tsv"))
    return {"root": root, "data": str(root / "data"), "mapping": mapping}


@pytest.mark.parametrize("scales", [("log", "log"), ("linear", "linear")])
def test_extrema_json_matches_the_jax_package_key_by_key(small_archive, scales, monkeypatch):
    from configurable_spectrograms_tpu.fast.extrema import compute_global_extrema as jax_extrema

    from configurable_spectrograms_torch.fast.extrema import compute_global_extrema, load_reference_extrema

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    y, z = scales
    insts = ("ees", "eeb", "ies", "ieb")
    root = small_archive["root"]
    p_jax, p_torch = str(root / f"jax_{y}{z}.json"), str(root / f"torch_{y}{z}.json")
    want = jax_extrema(small_archive["data"], y, z, insts, extrema_json_path=p_jax, flush_batch_size=2)
    got = compute_global_extrema(small_archive["data"], y, z, insts, extrema_json_path=p_torch, flush_batch_size=2)
    assert list(got) == list(want)
    for key in want:
        assert json.dumps(got[key]) == json.dumps(want[key]), key
    with open(p_jax) as a, open(p_torch) as b:
        assert a.read() == b.read()
    # A cache either package wrote drives the other: same keys, same values.
    assert load_reference_extrema(p_jax) == got
