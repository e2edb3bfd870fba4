"""The port's eager-torch panel analysis against the JAX package and the host oracle.

Same seeded configurations as tests/test_fuzz_parity.py: each goes through
``ops.spectrogram.quantize_matrix`` of both packages (JAX on its CPU
backend) and through ``render.host_quantize.host_quantize``.  Colour
bounds and mapping metadata must agree bit for bit; index matrices bit for
bit except cells provably on a colormap-bin boundary (docs/parity.md:93-127).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_fuzz_parity import COLORMAPS, _assert_idx_parity, _random_config  # noqa: E402

from configurable_spectrograms_torch.ops import spectrogram as S  # noqa: E402

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))[None]


def _zb(cfg) -> np.ndarray:
    return np.array([np.nan if v is None else v for v in cfg["z_bounds"]], np.float32)


def _torch_quantize(cfg):
    T, _ = cfg["matrix"].shape
    spec = S.RenderSpec(8, 8, cfg["y_scale"], cfg["z_scale"], cfg["low_pct"], cfg["high_pct"])
    out = S.quantize_matrix(
        _t(cfg["matrix"]), _t(cfg["energy"]), _t(cfg["e_valid"]), torch.tensor([T]),
        torch.tensor([cfg["t_start"]]), torch.tensor([cfg["t_count"]]), _t(_zb(cfg)), spec,
    )
    return {k: v[0].numpy() for k, v in out.items()}


@pytest.mark.parametrize("seed", range(48))
def test_quantize_matrix_matches_jax_and_host(seed):
    from configurable_spectrograms_tpu.ops import RenderSpec, quantize_matrix
    from configurable_spectrograms_tpu.render.host_quantize import host_quantize

    cfg = _random_config(seed)
    T, E = cfg["matrix"].shape
    got = _torch_quantize(cfg)
    ref = quantize_matrix(
        jnp.asarray(cfg["matrix"]), jnp.asarray(cfg["energy"]), jnp.asarray(cfg["e_valid"]),
        jnp.int32(T), jnp.int32(cfg["t_start"]), jnp.int32(cfg["t_count"]), jnp.asarray(_zb(cfg)),
        RenderSpec(8, 8, cfg["y_scale"], cfg["z_scale"], cfg["low_pct"], cfg["high_pct"]),
    )
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for k in ("vmin", "vmax", "y0", "y1", "n_kept", "flip", "empty"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"seed {seed}: {k} vs JAX")
    n = int(ref["n_kept"])
    np.testing.assert_array_equal(got["kept_pos"][:n], ref["kept_pos"][:n])
    try:
        host = host_quantize(cfg["matrix"], cfg["energy"], cfg["e_valid"], cfg["t_start"], cfg["t_count"],
                             cfg["z_bounds"], cfg["y_scale"], cfg["z_scale"], cfg["low_pct"], cfg["high_pct"])
    except ValueError:
        # The host raises matplotlib's LogNorm error; the device metadata
        # must carry vmin > vmax so the dispatch records the same error.
        assert cfg["z_scale"] == "log" and not got["empty"] and got["vmin"] > got["vmax"]
        return
    assert bool(got["empty"]) == host["empty"]
    if host["empty"]:
        return
    for k in ("vmin", "vmax"):
        np.testing.assert_array_equal(np.float32(got[k]), np.float32(host[k]), err_msg=f"seed {seed}: {k} vs host")
    sel = np.zeros((T, E), bool)
    sel[cfg["t_start"]: cfg["t_start"] + cfg["t_count"], host["kept_pos"][: host["n_kept"]]] = True
    _assert_idx_parity(got["idx"], host["idx"], sel, cfg, host, seed)
    _assert_idx_parity(got["idx"], ref["idx"], sel, cfg, host, seed)


@pytest.mark.parametrize("q", [0.0, 1.0, 37.5, 50.0, 99.0, 100.0])
def test_masked_nanpercentile_matches_numpy_and_jax(q):
    from configurable_spectrograms_tpu.ops import masked_nanpercentile

    rng = np.random.default_rng(int(q * 10) + 3)
    values = (rng.standard_normal((3, 40, 12)) * 1e3).astype(np.float32)
    values[rng.random(values.shape) < 0.1] = np.nan
    values[1, 0, 0], values[1, 2, 3] = np.inf, -np.inf
    valid = rng.random(values.shape) < 0.8
    valid[2] = False  # nothing valid: NaN
    got = S.masked_nanpercentile(torch.from_numpy(values), torch.from_numpy(valid), q).numpy()
    for lane in range(3):
        want_jax = np.asarray(masked_nanpercentile(jnp.asarray(values[lane]), jnp.asarray(valid[lane]), q))
        np.testing.assert_array_equal(got[lane], want_jax)
        pool = values[lane][valid[lane] & ~np.isnan(values[lane])]
        if lane == 1:
            continue  # numpy's lerp turns an inf endpoint into NaN; JAX's and ours keep it
        if pool.size:
            np.testing.assert_array_equal(got[lane], np.percentile(pool, q).astype(np.float32))
        else:
            assert np.isnan(got[lane])


def test_select_order_stats_equals_sorting():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((2, 500)).astype(np.float32)
    vals[0, :7] = [np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 3e38]
    ok = rng.random(vals.shape) < 0.9
    keys = S._sortable_u32(torch.from_numpy(vals), torch.from_numpy(ok))
    ranks = torch.tensor([[0, 5, 100, 300], [1, 2, 3, 400]])
    got = S.select_order_stats(keys, ranks).numpy()
    for lane in range(2):
        srt = np.sort(vals[lane][ok[lane]])
        np.testing.assert_array_equal(got[lane], srt[ranks[lane].numpy()])


@pytest.mark.parametrize("seed", [1, 4, 9, 20, 33])
def test_render_matrix_matches_jax_and_the_host_resampler(seed):
    from configurable_spectrograms_tpu.ops import RenderSpec, render_matrix

    from configurable_spectrograms_torch.ops._colormap_data import colormap_lut
    from configurable_spectrograms_torch.render.tile import TimeWindow, make_x_map, resample_indices

    cfg = _random_config(seed)
    T, E = cfg["matrix"].shape
    ts, tc = cfg["t_start"], cfg["t_count"]
    window = TimeWindow(ts, tc, (float(ts), float(ts + max(tc - 1, 0))), (float(ts), float(ts + max(tc, 1))))
    x_map = make_x_map(window, cfg["W"])
    lut = colormap_lut(cfg["colormap"])
    spec = S.RenderSpec(cfg["H"], cfg["W"], cfg["y_scale"], cfg["z_scale"], cfg["low_pct"], cfg["high_pct"])
    got = S.render_matrix(_t(cfg["matrix"]), _t(cfg["energy"]), _t(cfg["e_valid"]), torch.tensor([T]),
                          torch.tensor([ts]), torch.tensor([tc]), _t(x_map), _t(_zb(cfg)), _t(lut), spec)
    rgba = got["rgba"][0].numpy()
    ref = render_matrix(
        jnp.asarray(cfg["matrix"]), jnp.asarray(cfg["energy"]), jnp.asarray(cfg["e_valid"]), jnp.int32(T),
        jnp.int32(ts), jnp.int32(tc), jnp.asarray(x_map), jnp.asarray(_zb(cfg)), jnp.asarray(lut),
        RenderSpec(cfg["H"], cfg["W"], cfg["y_scale"], cfg["z_scale"], cfg["low_pct"], cfg["high_pct"]),
    )
    for k in ("vmin", "vmax", "y0", "y1", "n_kept", "empty"):
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(ref[k]), err_msg=k)
    q = _torch_quantize(cfg)
    tile = resample_indices(q["idx"], q["kept_pos"], int(q["n_kept"]), bool(q["flip"]), float(q["y0"]),
                            float(q["y1"]), ts, tc, x_map, cfg["H"], cfg["W"], cfg["y_scale"], lut,
                            empty=bool(q["empty"]))
    np.testing.assert_array_equal(rgba, tile)
    np.testing.assert_array_equal(rgba, np.asarray(ref["rgba"]))


def test_render_panels_is_render_matrix_per_lane():
    from configurable_spectrograms_torch.ops._colormap_data import colormap_lut

    cfgs = [_random_config(s) for s in (2, 5)]
    T, E = 64, 10
    rng = np.random.default_rng(5)
    mats = (rng.random((2, T, E)) * 100).astype(np.float32)
    energy = np.tile(np.geomspace(4000, 5, E).astype(np.float32), (2, 1))
    spec = S.RenderSpec(20, 30, "log", "log")
    args = [torch.from_numpy(mats), torch.from_numpy(energy), torch.ones((2, E), dtype=torch.bool),
            torch.tensor([T, 50]), torch.tensor([0, 5]), torch.tensor([T, 30]),
            torch.tensor([[0.5, 0.0], [0.9, 0.1]]), torch.tensor([[np.nan, np.nan], [1.0, 90.0]]),
            torch.from_numpy(np.stack([colormap_lut(c["colormap"]) for c in cfgs]))]
    both = S.render_panels(*args, spec)
    for j in range(2):
        one = S.render_matrix(*[a[j: j + 1] for a in args], spec)
        assert torch.equal(both["rgba"][j], one["rgba"][0])


@pytest.mark.parametrize("name", COLORMAPS + ("cividis",))
def test_colormap_luts_equal_the_reference(name):
    from configurable_spectrograms_tpu.ops._colormap_data import colormap_lut as ref_lut

    from configurable_spectrograms_torch.ops._colormap_data import AVAILABLE_COLORMAPS, colormap_lut

    assert name in AVAILABLE_COLORMAPS
    np.testing.assert_array_equal(colormap_lut(name), ref_lut(name))
