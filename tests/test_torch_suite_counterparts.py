"""The port's own tests of behaviours whose JAX tests cannot run against it.

Each test here holds the port to the contract of one JAX test that
``tests/test_torch_jax_suite.py`` classes as not applicable (it imports
``jax`` to build its inputs, or reaches ``render.link``, a private hook or
``render.fastpng.native_available``), where no other port test held that
behaviour.  The JAX test each one stands in for is named in its docstring
and in ``NOT_APPLICABLE`` there.

The device follows ``CST_TORCH_DEVICE`` (the CPU when it is unset), so
``chip_smoke.py``'s ``[suite]`` runs these tests on the card too.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from configurable_spectrograms_torch.ops import spectrogram as S
from configurable_spectrograms_torch.render.host_quantize import host_quantize

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_device(monkeypatch):
    """The device of ``CST_TORCH_DEVICE``, the CPU when it is unset."""
    monkeypatch.setenv("CST_TORCH_DEVICE", os.environ.get("CST_TORCH_DEVICE", "cpu"))
    monkeypatch.delenv("CST_RENDER_BACKEND", raising=False)


def _device() -> torch.device:
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    return get_device()


def _quantize(matrix, energy, e_valid, t_start, t_count, bounds, spec) -> dict:
    T = matrix.shape[0]
    dev = _device()
    out = S.quantize_matrix(
        torch.from_numpy(matrix)[None].to(dev), torch.from_numpy(energy)[None].to(dev),
        torch.from_numpy(e_valid)[None].to(dev), torch.tensor([T], device=dev), torch.tensor([t_start], device=dev),
        torch.tensor([t_count], device=dev), torch.tensor([bounds], dtype=torch.float32, device=dev), spec,
    )
    return {k: v[0].cpu().numpy() for k, v in out.items()}


@pytest.mark.parametrize("z_scale", ["linear", "log"])
def test_equal_bounds_paint_whole_panel_lut0(z_scale):
    """test_fuzz_parity.py::test_equal_bounds_paint_whole_panel_lut0 on the port's device analysis.

    The log case's reference is matplotlib's LogNorm: where matplotlib is
    not installed (the card's machine), that case skips.
    """
    rng = np.random.default_rng(7)
    T, E = 40, 12
    matrix = (rng.random((T, E)) * 50 + 0.5).astype(np.float32)
    matrix[3, 4] = np.nan
    matrix[5, 2] = -1.0
    energy = np.geomspace(4000, 5, E).astype(np.float32)
    e_valid = np.ones(E, bool)
    v = 7.25
    dev = _quantize(matrix, energy, e_valid, 0, T, [v, v], S.RenderSpec(16, 16, "linear", z_scale))
    host = host_quantize(matrix, energy, e_valid, 0, T, (v, v), "linear", z_scale, 1.0, 99.0)
    if z_scale == "linear":
        np.testing.assert_array_equal(dev["idx"], host["idx"])
        return
    mcolors = pytest.importorskip("matplotlib.colors")
    expected = mcolors.LogNorm(vmin=v, vmax=v)(np.where(~np.isfinite(matrix) | (matrix <= 0), v, matrix))
    assert float(np.asarray(expected).max()) == 0.0
    assert np.all(dev["idx"] == 0) and np.all(host["idx"] == 0)


@pytest.mark.parametrize("z_scale", ["linear", "log"])
def test_nan_percentile_bounds_pin_lut0_on_both_backends(z_scale):
    """test_fuzz_parity.py::test_nan_percentile_bounds_pin_lut0_on_both_backends: an all-NaN window."""
    rng = np.random.default_rng(11)
    T, E = 24, 10
    matrix = (rng.random((T, E)) * 40 + 1.0).astype(np.float32)
    matrix[6:12, :] = np.nan
    energy = np.geomspace(4000, 5, E).astype(np.float32)
    e_valid = np.ones(E, bool)
    dev = _quantize(matrix, energy, e_valid, 6, 6, [np.nan, np.nan], S.RenderSpec(16, 16, "linear", z_scale))
    host = host_quantize(matrix, energy, e_valid, 6, 6, (None, None), "linear", z_scale, 1.0, 99.0)
    assert not bool(dev["empty"]) and not host["empty"]
    np.testing.assert_array_equal(dev["idx"], host["idx"])
    if z_scale == "log":
        assert np.isnan(host["vmin"]) and np.isnan(host["vmax"])
        assert np.all(host["idx"] == 0) and np.all(dev["idx"] == 0)


def test_masked_nanpercentile_empty_and_infinities():
    """test_ops.py::test_masked_nanpercentile_empty and test_ops.py::test_masked_nanpercentile_with_inf."""
    dev = _device()
    empty = S.masked_nanpercentile(torch.ones((1, 4, 4), device=dev), torch.zeros((1, 4, 4), dtype=torch.bool,
                                                                                      device=dev), 50.0)
    assert torch.isnan(empty).all()
    vals = torch.tensor([[1.0, 2.0, np.inf, -np.inf, np.nan]], device=dev)
    valid = torch.ones_like(vals, dtype=torch.bool)
    assert float(S.masked_nanpercentile(vals, valid, 100.0)[0]) == np.inf
    assert float(S.masked_nanpercentile(vals, valid, 0.0)[0]) == -np.inf
    assert float(S.masked_nanpercentile(vals, valid, 50.0)[0]) == 1.5


def test_host_resample_empty():
    """test_quantize_path.py::test_host_resample_empty: an empty panel is all background (index 255)."""
    from configurable_spectrograms_torch.ops._colormap_data import colormap_lut
    from configurable_spectrograms_torch.render.tile import resample_indices

    tile = resample_indices(
        np.zeros((4, 4), np.uint8), np.arange(4), 0, False, 0.0, 1.0, 0, 0,
        np.array([1.0, 0.0], np.float32), 8, 8, "linear", colormap_lut("viridis"), empty=True,
    )
    assert np.all(tile == 255)


def test_long_record_renders_the_jax_packages_pixels(monkeypatch):
    """test_quantize_path.py::test_pre_gather_path_matches_direct: T >> W, where the dispatch gathers
    the rows the pixels sample on the device; the JAX test's reference is a jitted ``render_matrix``.
    Here the port's gathered render must give the JAX package's device pixels and the port's host pixels.
    """
    from configurable_spectrograms_tpu.render import link
    from configurable_spectrograms_tpu.render.figure import PanelData as JaxPanel
    from configurable_spectrograms_tpu.render.figure import device_render_panels as jax_render
    from configurable_spectrograms_tpu.render.tile import TimeWindow as JaxWindow

    from configurable_spectrograms_torch.render.figure import PanelData, device_render_panels
    from configurable_spectrograms_torch.render.tile import TimeWindow

    rng = np.random.default_rng(1234)
    T, A, E = 700, 6, 12
    cube = (rng.random((T, A, E)) * 300).astype(np.float32)
    energy = np.geomspace(4000, 10, E).astype(np.float32)

    def build(panel, window):
        return panel(cube=cube, pitch_mask=np.ones(A, bool), energy=energy, times=np.arange(T, dtype=np.float64),
                     window=window(10, 600, (10.0, 609.0), (5.0, 615.0)), y_min=0.0, y_max=4000.0,
                     z_min=None, z_max=None, y_scale="log", z_scale="log", colormap="inferno",
                     x_is_unix=True, z_label="Counts")

    port = device_render_panels([build(PanelData, TimeWindow)], 40, 120)[0]
    mode = link._BACKEND["mode"]
    link._BACKEND["mode"] = "device"
    try:
        ref = jax_render([build(JaxPanel, JaxWindow)], 40, 120)[0]
    finally:
        link._BACKEND["mode"] = mode
    np.testing.assert_array_equal(port["rgba"], np.asarray(ref["rgba"]))
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    host = device_render_panels([build(PanelData, TimeWindow)], 40, 120)[0]
    np.testing.assert_array_equal(port["rgba"], host["rgba"])


@pytest.mark.parametrize("backend", ["device", "host"])
def test_inverted_log_bounds_error_scoped_to_owning_figure(backend, monkeypatch):
    """test_production_sharding.py::test_inverted_log_bounds_error_scoped_to_owning_figure, per backend."""
    from configurable_spectrograms_torch.render.figure import PanelData, device_render_panels
    from configurable_spectrograms_torch.render.plotting import generic_plot_multirow_optional_zoom
    from configurable_spectrograms_torch.render.tile import TimeWindow

    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    rng = np.random.default_rng(1234)
    panels = []
    for k in range(3):
        T, A, E = 60 + 3 * k, 6, 12
        cube = (rng.random((T, A, E)) * (50 + 10 * k)).astype(np.float32)
        cube[rng.random(cube.shape) < 0.05] = np.nan
        panels.append(PanelData(
            cube=cube, pitch_mask=np.ones(A, bool), energy=np.geomspace(4000, 10, E).astype(np.float32),
            times=np.arange(T, dtype=np.float64), window=TimeWindow(0, T, (0.0, T - 1.0), (0.0, T - 1.0)),
            y_min=0.0, y_max=4000.0, z_min=None, z_max=None, y_scale="log", z_scale="log",
            colormap="inferno", x_is_unix=False, z_label="Counts"))
    panels[1].cube = np.full_like(panels[1].cube, 500.0)
    panels[1].z_min, panels[1].z_max = 1.0, 80.0
    results = device_render_panels(panels, 32, 48)
    assert results[1].get("error") and "minvalue" in results[1]["error"]
    for j in (0, 2):
        assert "error" not in results[j] and results[j]["rgba"].shape[2] == 4
    ds = [{"x": np.arange(64.0), "y": np.geomspace(4000, 10, 12), "data": np.full((64, 6, 12), 500.0, np.float32),
           "label": "bad", "vmin": 1.0, "vmax": 80.0}]
    fig, _ = generic_plot_multirow_optional_zoom(ds, z_scale="log", show=False)
    with pytest.raises(ValueError, match="minvalue"):
        fig.render(dpi=40)


def test_canvas_pool_depth_follows_worker_demand(monkeypatch):
    """test_compositor.py::test_canvas_pool_depth_follows_worker_demand; the port's wiring is
    ``render.backend.recommended_workers`` (the JAX test reaches it through ``render.link``)."""
    from configurable_spectrograms_torch.render import backend, compositor

    monkeypatch.delenv("CST_CANVAS_POOL_PER_SIZE", raising=False)
    before = compositor._CANVAS_POOL_MAX_PER_SIZE
    try:
        compositor.ensure_canvas_pool_depth(before + 3)
        assert compositor._CANVAS_POOL_MAX_PER_SIZE == before + 3
        compositor.ensure_canvas_pool_depth(1)
        assert compositor._CANVAS_POOL_MAX_PER_SIZE == before + 3
        monkeypatch.setenv("CST_CANVAS_POOL_PER_SIZE", "2")
        compositor.ensure_canvas_pool_depth(64)
        assert compositor._CANVAS_POOL_MAX_PER_SIZE == before + 3
        monkeypatch.delenv("CST_CANVAS_POOL_PER_SIZE")
        monkeypatch.setenv("CST_RENDER_BACKEND", "device")
        assert backend.recommended_workers(before + 7) == before + 7
        assert compositor._CANVAS_POOL_MAX_PER_SIZE == before + 7
    finally:
        compositor._CANVAS_POOL_MAX_PER_SIZE = before


def test_fastpng_concurrent_encodes(tmp_path):
    """test_compositor.py::test_fastpng_concurrent_encodes: four threads encoding at once round-trip exactly."""
    from configurable_spectrograms_torch.render.fastpng import write_png_rgb

    rng = np.random.default_rng(1234)
    white = np.full((240, 400, 3), 255, np.uint8)
    imgs = []
    for k in range(12):
        a = white.copy()
        a[20:200, 30 + k:350] = (rng.random((180, 320 - k, 3)) * 255).astype(np.uint8)
        imgs.append(a)

    def enc(k):
        path = str(tmp_path / f"c{k}.png")
        write_png_rgb(imgs[k], path)
        return k, path

    with ThreadPoolExecutor(max_workers=4) as pool:
        for k, path in pool.map(enc, range(len(imgs))):
            with Image.open(path) as im:
                np.testing.assert_array_equal(np.asarray(im), imgs[k])


@pytest.mark.parametrize("encoder", ["auto", "rle", "libdeflate"])
def test_fastpng_roundtrip_on_every_encoder_path(encoder, tmp_path, monkeypatch):
    """test_compositor.py::test_fastpng_roundtrip and test_compositor.py::test_fastpng_rle_encoder_roundtrip: every canvas
    shape decodes to its pixels on each deflate path; a malformed array raises (the port has no fallback)."""
    from configurable_spectrograms_torch.render.fastpng import write_png_rgb

    if encoder != "auto":
        monkeypatch.setenv("FASTPNG_ENCODER", encoder)
    rng = np.random.default_rng(1234)
    white = np.full((300, 500, 3), 255, np.uint8)
    tiles = white.copy()
    tiles[40:200, 60:400] = (rng.random((160, 340, 3)) * 255).astype(np.uint8)
    cases = {
        "random": (rng.random((64, 96, 3)) * 255).astype(np.uint8),
        "white": white,
        "tiles": tiles,
        "noise": (rng.random((257, 333, 3)) * 255).astype(np.uint8),
        "tiny": (rng.random((1, 1, 3)) * 255).astype(np.uint8),
        "stripes": np.tile((rng.random((1, 64, 3)) * 255).astype(np.uint8), (64, 3, 1)),
        "rgba": np.dstack([tiles, np.full(tiles.shape[:2], 77, np.uint8)]),
    }
    for name, arr in cases.items():
        path = str(tmp_path / f"{name}.png")
        write_png_rgb(arr, path)
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im), arr[:, :, :3], err_msg=name)
    with pytest.raises(ValueError):
        write_png_rgb(cases["random"][:, :, :2], str(tmp_path / "bad.png"))
