"""The percentile-quantize kernel of the render dispatch's collapse route.

On the CPU the wrapper takes its plain version, ``ops.spectrogram.quantize_matrix``,
and the dispatch's collapse route stays on it, counting no launch.  On a card
(``-m cuda``) the kernel is held to that plain version run eagerly on the same
card: vmin, vmax, n_kept, kept_pos, flip, y0, y1 and empty bit for bit, and each
index exact or one bin apart where the cell sits on a bin boundary
(``chip_smoke.boundary_mask``: two float32 log10s round to neighbouring bins).
The cases: the kernel sweep's seeded lanes in both z scales, with and without
the percentile select; lanes with partial masks, no file rows, +-inf, a pool of
one cell, an empty window, a pool of infinities; the backend-divergence seeds of
``tests/test_torch_kernel_sweep.py`` through the whole dispatch; the audio
figure's bucket (1 lane of 1024 x 520) and a FAST bucket (8 lanes of
1024 x 96).  Its radix select alone is held to ``select_order_stats``.
This file imports neither jax nor the JAX package.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from configurable_spectrograms_torch.ops import kernels as K  # noqa: E402
from configurable_spectrograms_torch.ops import spectrogram as S  # noqa: E402

torch.set_num_threads(1)

SWEEP_SEEDS = range(48)
DIVERGENT_SEEDS = (28, 47, 192)


_bucket = chip_smoke.percentile_bucket


def _tensors(b: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in b.items()}


def _run(x: dict, z_scale: str, skip: bool, fn, low: float = 1.0, high: float = 99.0) -> dict:
    spec = S.RenderSpec(8, 8, "linear", z_scale, low, high)
    q = fn(x["matrix"], x["energy"], x["e_valid"], x["t_valid"], x["t_start"], x["t_count"], x["z_bounds"], spec,
           zb_e_valid=x["zb_e_valid"], zb_full_time=x["zb_full_time"], skip_percentile=skip)
    return {k: v.cpu().numpy() for k, v in q.items()}


def _assert_same(got: dict, want: dict, matrix: np.ndarray, z_scale: str, where: str) -> int:
    """The kernel's contract against the eager version; returns the cells one bin apart (all on a boundary)."""
    faults, off = chip_smoke.percentile_contract(got, want, matrix, z_scale)
    assert not faults, f"{where}: " + "; ".join(faults)
    return off


def _hold_to_eager(x: dict, where: str) -> int:
    off = 0
    m = x["matrix"].cpu().numpy()
    for z_scale in ("log", "linear"):
        for skip in (False, True):
            got = _run(x, z_scale, skip, K.percentile_quantize_lanes)
            want = _run(x, z_scale, skip, S.quantize_matrix)
            off += _assert_same(got, want, m, z_scale, f"{where} z={z_scale} skip={skip}")
    return off


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# -- the CPU -----------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(monkeypatch):
    calls = []
    real = S.quantize_matrix
    monkeypatch.setattr(S, "quantize_matrix", lambda *a, **k: calls.append(1) or real(*a, **k))
    K.reset_launches()
    x = _tensors(_bucket(np.random.default_rng(1), 3, 40, 12), "cpu")
    got = _run(x, "log", False, K.percentile_quantize_lanes)
    want = _run(x, "log", False, real)
    assert calls == [1] and K.LAUNCHES["percentile_quantize"] == 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_the_dispatch_collapse_route_on_cpu_tensors_stays_eager(monkeypatch):
    """A percentile bucket and a degenerate explicit bucket render through ``quantize_matrix`` on the CPU."""
    from configurable_spectrograms_torch.render.dispatch import device_render_panels

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    skips = []
    real = S.quantize_matrix

    def counted(*a, skip_percentile=False, **k):
        skips.append(skip_percentile)
        return real(*a, skip_percentile=skip_percentile, **k)

    monkeypatch.setattr(S, "quantize_matrix", counted)
    K.reset_launches()
    case = chip_smoke.sweep_case(3, max_cells=1 << 14)
    panels = chip_smoke.sweep_panels(case)
    for p in panels[:2]:
        p.z_min, p.z_max = 5.0, 5.0  # explicit and degenerate: the collapse route with the select off
    for p in panels[2:]:
        p.z_min = p.z_max = None
    results = device_render_panels(panels, 24, 32)
    assert len(results) == len(panels) and sorted(set(skips)) == [False, True]
    assert K.LAUNCHES["percentile_quantize"] == 0 and K.LAUNCHES["collapse"] == 0


@pytest.mark.parametrize("bad", ["matrix", "energy", "t_valid", "z_bounds", "zb_full_time", "z_scale"])
def test_wrapper_rejects_inputs_the_kernel_does_not_take(bad):
    x = _tensors(_bucket(np.random.default_rng(2), 2, 16, 8), "cpu")
    spec = S.RenderSpec(8, 8, "linear", "log")
    if bad == "matrix":
        x["matrix"] = x["matrix"].double()
    elif bad == "energy":
        x["energy"] = x["energy"][:, :4]
    elif bad == "t_valid":
        x["t_valid"] = x["t_valid"].long()
    elif bad == "z_bounds":
        x["z_bounds"] = x["z_bounds"][:, :1]
    elif bad == "zb_full_time":
        x["zb_full_time"] = x["zb_full_time"].int()
    else:
        spec = S.RenderSpec(8, 8, "linear", "sqrt")
    with pytest.raises(ValueError):
        K.percentile_quantize_lanes(x["matrix"], x["energy"], x["e_valid"], x["t_valid"], x["t_start"],
                                    x["t_count"], x["z_bounds"], spec, zb_e_valid=x["zb_e_valid"],
                                    zb_full_time=x["zb_full_time"])


def test_special_lanes_reach_their_cases():
    """What the card's special-lane test holds the kernel to, on the plain version."""
    x = _special_lanes("cpu")
    log = _run(x, "log", False, S.quantize_matrix)
    lin = _run(x, "linear", False, S.quantize_matrix)
    assert log["n_kept"][1] == 0 and log["empty"][1] and np.isnan(log["vmin"][1])  # no file rows
    assert log["n_kept"][3] == 1 and log["vmin"][3] == log["vmax"][3] == np.float32(4.5)  # a pool of one cell
    assert (log["idx"][3] == 0).all()
    assert log["empty"][4] and not log["empty"][0]  # an empty window
    assert np.isinf(lin["vmax"][5]) or np.isnan(lin["vmax"][5])  # a pool of infinities
    assert log["n_kept"][6] == 0  # no e_valid column
    m = x["matrix"].numpy()
    assert np.isposinf(m[2]).any() and np.isneginf(m[2]).any()
    assert log["flip"].any() and not log["flip"].all()


# -- the card ----------------------------------------------------------------------------


def _special_lanes(device) -> dict:
    """Eight lanes, one a case: plain; no file rows; +-inf cells; a pool of one cell; an empty window;
    a pool of infinities; no e_valid column; the bounds over the whole file and a few columns."""
    rng = np.random.default_rng(7)
    b = _bucket(rng, 8, 300, 50, cells="signed")
    m = b["matrix"]
    b["t_valid"][1] = 0
    m[1] = np.nan
    m[2, rng.random((300, 50)) < 0.02] = np.inf
    m[2, rng.random((300, 50)) < 0.02] = -np.inf
    m[3] = np.nan
    m[3, 17, 9] = 4.5
    b["t_start"][3], b["t_count"][3], b["t_valid"][3] = 0, 300, 300
    b["e_valid"][3, 9] = b["zb_e_valid"][3, 9] = True
    b["zb_full_time"][3] = False
    b["t_count"][4] = 0
    m[5, : b["t_valid"][5]] = np.inf
    b["e_valid"][6] = False
    b["zb_full_time"][7] = True
    b["zb_e_valid"][7] = False
    b["zb_e_valid"][7, 10:14] = True
    return _tensors(b, device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SWEEP_SEEDS)
def test_cuda_sweep_lanes_match_eager_analyze_matrix(cuda, seed):
    """The sweep's seeded lanes (padded and unpadded shapes, every value class, lanes on several cubes)."""
    case = chip_smoke.sweep_case(seed, max_cells=1 << 20)
    x = chip_smoke._sweep_lanes(case, cuda)
    lanes = chip_smoke.sweep_percentile_lanes(case, K.collapse_lanes(x["cubes"], x["u_idx"], x["masks"],
                                                                     x["t_valid"]), cuda)
    _hold_to_eager(lanes, chip_smoke.describe_case(case, "collapse"))


@pytest.mark.cuda
def test_cuda_special_lanes_match_eager_analyze_matrix(cuda):
    x = _special_lanes(cuda)
    _hold_to_eager(x, "special lanes")
    for low, high in ((0.0, 100.0), (50.0, 50.0), (12.5, 87.5)):
        for z_scale in ("log", "linear"):
            got = _run(x, z_scale, False, K.percentile_quantize_lanes, low, high)
            want = _run(x, z_scale, False, S.quantize_matrix, low, high)
            _assert_same(got, want, x["matrix"].cpu().numpy(), z_scale, f"special lanes q=({low}, {high})")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1024, 520), (8, 1024, 96), (8, 1024, 100), (3, 37, 1500)])
def test_cuda_served_shapes_match_eager_analyze_matrix(cuda, shape):
    """The audio figure's bucket (1 lane of 1024 x 520: ~530k cells, the largest cluster), a FAST bucket of
    8 lanes, E not a multiple of 8, and rows wider than a block."""
    x = _tensors(_bucket(np.random.default_rng(sum(shape)), *shape), cuda)
    _hold_to_eager(x, f"shape {shape}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", DIVERGENT_SEEDS)
def test_cuda_backend_divergences_follow_the_eager_device_route(cuda, seed, monkeypatch):
    """The panels whose device and host renders differ (a pool of one cell or of infinities) render on the
    kernel as the eager device route renders them on the card."""
    from configurable_spectrograms_torch.render import dispatch
    from configurable_spectrograms_torch.render.host_quantize import host_collapse

    monkeypatch.setenv("CST_TORCH_DEVICE", "cuda")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    panels = chip_smoke.sweep_panels(chip_smoke.sweep_case(seed, max_cells=1 << 20))
    K.reset_launches()
    got = dispatch.device_render_panels(panels, 48, 64)
    assert K.LAUNCHES["percentile_quantize"] >= 1
    monkeypatch.setattr(dispatch, "percentile_quantize_lanes", S.quantize_matrix)
    want = dispatch.device_render_panels(panels, 48, 64)
    for i, (p, g, w) in enumerate(zip(panels, got, want)):
        assert g.get("error") == w.get("error"), f"panel {i}"
        if "error" in w:
            continue
        for k in ("vmin", "vmax", "y0", "y1", "n_kept", "empty"):
            a, b = np.float32(g[k]), np.float32(w[k])
            assert np.array_equal(a, b, equal_nan=True), f"panel {i} {k}: {a!r} vs {b!r}"
        np.testing.assert_array_equal(g["idx_rows"], w["idx_rows"])
        d = np.abs(g["idx"].astype(np.int32) - w["idx"].astype(np.int32))
        assert d.max(initial=0) <= 1, f"panel {i}"
        if d.any():
            T, _, E = p.cube.shape
            rows = w["idx_rows"][: w["idx"].shape[0]]
            off = d[rows < T][:, :E] > 0
            assert off.sum() == (d > 0).sum(), f"panel {i}: a padding cell differs"
            m = host_collapse(p.cube, p.pitch_mask)[rows[rows < T]]
            with np.errstate(all="ignore"):
                on = chip_smoke.boundary_mask(m, float(w["vmin"]), float(w["vmax"]), p.z_scale, off)
            assert on.sum() == off.sum(), f"panel {i}: cells one bin apart off a boundary"


@pytest.mark.cuda
def test_cuda_radix_select_matches_select_order_stats(cuda):
    """The kernel's four order statistics alone, on keys with ties, +-0, +-inf, subnormals and masked-out cells."""
    rng = np.random.default_rng(11)
    L, T, E = 6, 400, 7
    pool = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 1.5e-45, 1.0, -1.0, 3.0, 3.0, 2.5e38, np.nan],
                    np.float32)
    m = rng.choice(pool, (L, T, E)).astype(np.float32)
    m[1] = rng.normal(0, 1, (T, E)).astype(np.float32)
    m[2] = np.float32(3.0)  # all ties
    x = {"matrix": m, "energy": np.ones((L, E), np.float32), "e_valid": np.ones((L, E), bool),
         "t_valid": np.array([T, T, T, 300, T, 0], np.int32), "t_start": np.array([0, 10, 0, 50, 0, 0], np.int32),
         "t_count": np.array([T, 200, T, 100, 1, 0], np.int32), "z_bounds": np.full((L, 2), np.nan, np.float32),
         "zb_e_valid": rng.random((L, E)) < 0.7, "zb_full_time": np.array([0, 0, 1, 0, 0, 0], bool)}
    x["zb_e_valid"][4] = True
    xc = _tensors(x, cuda)
    rows = np.arange(T)[None, :]
    in_file = rows < x["t_valid"][:, None]
    in_win = in_file & (rows >= x["t_start"][:, None]) & (rows < (x["t_start"] + x["t_count"])[:, None])
    zb_rows = np.where(x["zb_full_time"][:, None], in_file, in_win)
    ok = torch.from_numpy((zb_rows[:, :, None] & x["zb_e_valid"][:, None, :] & ~np.isnan(m)).reshape(L, -1))
    flat = torch.from_numpy(m.reshape(L, -1))
    n = ok.sum(dim=1)
    keys = S._sortable_u32(flat, ok)
    for low, high in ((1.0, 99.0), (0.0, 100.0), (50.0, 50.0), (12.5, 66.7)):
        lo1, hi1, _ = S._percentile_ranks(low, n)
        lo2, hi2, _ = S._percentile_ranks(high, n)
        want = S.select_order_stats(keys, torch.stack([lo1, hi1, lo2, hi2], dim=1)).numpy()
        idx, words, flags = K.percentile_quantize_buffers(L, T, E, cuda)
        args = tuple(xc[k] for k in ("matrix", "energy", "e_valid", "zb_e_valid", "t_valid", "t_start", "t_count",
                                     "z_bounds", "zb_full_time"))
        K.percentile_quantize_launch(args, "linear", low, high, True, idx, words, flags)
        w = words.cpu().numpy()
        np.testing.assert_array_equal(w[:, 2 * E + 5], n.numpy())
        got = w[:, 2 * E + 6: 2 * E + 10].view(np.float32)
        live = n.numpy() > 0
        np.testing.assert_array_equal(got[live].view(np.int32), want[live].view(np.int32), err_msg=f"q=({low}, {high})")
        assert np.isnan(got[~live]).all() and np.isnan(want[~live]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1024, 520), (8, 1024, 96), (3, 37, 1500)])
def test_cuda_writes_stay_inside_their_buffers(cuda, shape):
    """Each output sits between poisoned zones; the kernel writes no byte of them and leaves no output unwritten."""
    L, T, E = shape
    x = _tensors(_bucket(np.random.default_rng(3), L, T, E), cuda)
    guard = 1 << 16
    sizes = (L * T * E, L * (2 * E + K.PQ_SCALARS) * 4, L * 2)
    bufs = [torch.full((n + 2 * guard,), 0x5A, dtype=torch.uint8, device=cuda) for n in sizes]
    idx = bufs[0][guard:guard + sizes[0]].view(L, T, E)
    words = bufs[1][guard:guard + sizes[1]].view(torch.int32).view(L, 2 * E + K.PQ_SCALARS)
    flags = bufs[2][guard:guard + sizes[2]].view(L, 2)
    args = tuple(x[k] for k in ("matrix", "energy", "e_valid", "zb_e_valid", "t_valid", "t_start", "t_count",
                                "z_bounds", "zb_full_time"))
    K.percentile_quantize_launch(args, "log", 1.0, 99.0, True, idx, words, flags)
    torch.cuda.synchronize()
    for b, n in zip(bufs, sizes):
        assert bool((b[:guard] == 0x5A).all()) and bool((b[guard + n:] == 0x5A).all())
    want = _run(x, "log", False, S.quantize_matrix)
    np.testing.assert_array_equal(words[:, :E].cpu().numpy(), want["kept_pos"])
    np.testing.assert_array_equal(flags.cpu().numpy().astype(bool), np.stack([want["flip"], want["empty"]], axis=1))
    d = np.abs(idx.cpu().numpy().astype(int) - want["idx"].astype(int))
    assert d.max() <= 1
