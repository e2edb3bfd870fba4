"""The kernel sweep's case generator, and the plain kernels against the JAX package over its cases.

``chip_smoke.sweep_case`` draws the seeded cases that the ``[sweep]`` phase
of ``chip_smoke.py`` holds each CUDA kernel to its plain version with, on
the card.  Here, on the CPU: the generator reaches every class of its
lattice over a fixed seed range, and over 16 seeds, capped to a few
thousand cells, the plain collapse and fused versions (what the kernels
are held to) agree with the JAX package -- the collapse exactly at
A <= 32 and within 4 * eps * sum|x| above (XLA:CPU stops adding in index
order there), and the fused quantize against ``fused_quantize_pallas`` in
the Pallas interpreter (at A <= 32): vmin and col_all_nan exact, each
index exact or one bin apart on a proven bin boundary.

Two differences of the JAX package are taken out of the comparison, each
pinned by its own test below:

* XLA:CPU flushes subnormal float32 values to zero; numpy, torch and the
  CUDA kernels keep them.  Both packages get each cube with its
  subnormals flushed (the card holds the kernels to the plain versions on
  the subnormals themselves).
* ``fused_quantize_pallas`` takes a window whose finite positive cells are
  all at or above its 3e38 sentinel for one with none (safe floor 1e-10);
  the JAX package's production route, ``_analyze_matrix``, does not, and
  the port's fused route follows it.  On such a lane vmin is held to that
  rule instead.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from configurable_spectrograms_torch.ops import kernels as K  # noqa: E402

torch.set_num_threads(1)

F32_EPS = float(np.finfo(np.float32).eps)
COVERAGE_SEEDS = range(64)
PARITY_SEEDS = range(16)
PARITY_CELLS = 1 << 13

REQUIRED_CLASSES = (
    {"padded", "unpadded", "several_groups_on_a_cube", "lanes_interleaved", "all_nan_columns", "all_nan_cube",
     "z_log", "z_linear", "stft_L16", "stft_L_tail", "stft_hop4", "stft_hop_odd"}
    | {f"value_{v}" for v in chip_smoke.SWEEP_VALUES}
    | {f"bounds_{b}" for b in chip_smoke.SWEEP_BOUNDS}
    | {f"mask_{k}" for k in ("none", "one", "all", "random")}
    | {f"t_valid_{k}" for k in ("zero", "one", "T-1", "T", "random")}
    | {f"e_valid_{k}" for k in ("none", "all", "random")}
    | {f"window_{k}" for k in ("empty", "whole", "random")}
)


def test_sweep_case_reaches_every_class():
    assert chip_smoke.SWEEP_GROUP == K.COLLAPSE_GROUP
    seen = set()
    for seed in COVERAGE_SEEDS:
        case = chip_smoke.sweep_case(seed, max_cells=1 << 12)
        seen |= case["classes"]
        U, T, A, E = case["shape"]
        if case["padded"]:
            assert T % 256 == 0 and T <= 8192 and A % 8 == 0 and 8 <= A <= 64 and E % 8 == 0 and 8 <= E <= 528
        else:
            assert 1 <= T <= 9000 and 1 <= A <= 64 and 1 <= E <= 200
        assert 1 <= U <= 3 and case["cubes"].shape == (U, T, A, E) and case["cubes"].dtype == np.float32
        L = len(case["u_idx"])
        assert 1 <= L <= 2 * K.COLLAPSE_GROUP + 3 and case["u_idx"].max() < U
        assert np.all((case["t_valid"] >= 0) & (case["t_valid"] <= T))
        assert np.all((case["t_start"] >= 0) & (case["t_start"] + case["t_count"] <= T))
        s = case["stft"]
        assert 1 <= s["F"] <= 20000 and 8 <= s["L"] <= 8192 and 1 <= s["hop"] <= s["L"]
        assert len(s["signal"]) == (s["F"] - 1) * s["hop"] + s["L"]
    assert REQUIRED_CLASSES <= seen, sorted(REQUIRED_CLASSES - seen)


def test_sweep_case_is_seeded():
    a, b = chip_smoke.sweep_case(5, max_cells=1 << 12), chip_smoke.sweep_case(5, max_cells=1 << 12)
    for k in ("cubes", "u_idx", "masks", "t_valid", "e_valid", "t_start", "t_count", "z_bounds"):
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["stft"]["signal"], b["stft"]["signal"])
    assert a["z_scale"] == b["z_scale"] and a["classes"] == b["classes"]


def test_parity_seeds_reach_both_pitch_regimes():
    """The parity cases below include exact (A <= 32) and toleranced (A > 32) collapses, and fused lanes."""
    widths = [chip_smoke.sweep_case(s, max_cells=PARITY_CELLS)["shape"][2] for s in PARITY_SEEDS]
    assert min(widths) <= 32 < max(widths)


def _flush_subnormals(a: np.ndarray) -> np.ndarray:
    """Subnormal float32 values -> zero of the same sign, as XLA:CPU reads them."""
    sub = (a != 0) & (np.abs(a) < np.finfo(np.float32).tiny)
    return np.where(sub, np.copysign(np.float32(0.0), a), a).astype(np.float32)


def _pad(cube: np.ndarray) -> np.ndarray:
    """(T, A, E) -> (T64, A, E128): the Pallas kernels' shape rule; the extra rows and columns are sliced off."""
    T, A, E = cube.shape
    out = np.full((-(-T // 64) * 64, A, -(-E // 128) * 128), np.nan, np.float32)
    out[:T, :, :E] = cube
    return out


@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_plain_kernels_match_the_jax_package_on_sweep_cases(seed):
    from configurable_spectrograms_tpu.ops.pallas_kernels import collapse_cube_pallas, fused_quantize_pallas

    case = chip_smoke.sweep_case(seed, max_cells=PARITY_CELLS)
    case["cubes"] = _flush_subnormals(case["cubes"])
    U, T, A, E = case["shape"]
    x = {k: torch.from_numpy(np.ascontiguousarray(case[k]))
         for k in ("cubes", "u_idx", "masks", "e_valid", "t_valid", "t_start", "t_count", "z_bounds")}
    lanes = (x["cubes"], x["u_idx"], x["masks"], x["t_valid"])
    got = K.collapse_lanes(*lanes).numpy()
    z = case["z_scale"]
    fused = K.fused_quantize_lanes(*lanes[:3], x["e_valid"], x["t_valid"], x["t_start"], x["t_count"],
                                   x["z_bounds"], z_scale=z)
    padded = [jnp.asarray(_pad(c)) for c in case["cubes"]]
    for j, u in enumerate(case["u_idx"].tolist()):
        mask, tv = case["masks"][j], int(case["t_valid"][j])
        want = np.asarray(collapse_cube_pallas(padded[u], jnp.asarray(mask), tv))[:T, :E]
        np.testing.assert_array_equal(np.isnan(got[j]), np.isnan(want), err_msg=f"lane {j}")
        if A <= 32:
            ok = ~np.isnan(want)
            np.testing.assert_array_equal(got[j][ok], want[ok], err_msg=f"lane {j}")
        else:
            np.testing.assert_array_equal(np.isinf(got[j]), np.isinf(want), err_msg=f"lane {j}")
            sel = np.where(np.isnan(case["cubes"][u]) | ~mask[None, :, None], 0.0,
                           np.abs(case["cubes"][u].astype(np.float64))).sum(axis=1)
            fin = np.isfinite(want)
            assert np.all(np.abs(got[j][fin].astype(np.float64) - want[fin]) <= 4 * F32_EPS * sel[fin]), f"lane {j}"
            continue
        ev = np.zeros(padded[u].shape[2], bool)
        ev[:E] = case["e_valid"][j]
        ref = fused_quantize_pallas(padded[u], jnp.asarray(mask), jnp.asarray(ev), tv, int(case["t_start"][j]),
                                    int(case["t_count"][j]), jnp.asarray(case["z_bounds"][j]), z_scale=z)
        rows = np.arange(T)[:, None]
        t0, t1 = int(case["t_start"][j]), int(case["t_start"][j] + case["t_count"][j])
        with np.errstate(invalid="ignore"):
            fp = np.isfinite(got[j]) & (got[j] > 0) & (rows < tv) & (rows >= t0) & (rows < t1) & case["e_valid"][j]
        if z == "log" and fp.any() and got[j][fp].min() >= np.float32(3e38):
            safe = np.where(fp, got[j], np.float32(3e38)).min()
            assert fused["vmin"][j].item() == max(np.float32(case["z_bounds"][j, 0]), safe), f"lane {j}"
            continue
        assert fused["vmin"][j].item() == float(ref["vmin"]), f"lane {j}"
        np.testing.assert_array_equal(fused["col_all_nan"][j].numpy(), np.asarray(ref["col_all_nan"])[:E])
        d = np.abs(fused["idx"][j].numpy().astype(int) - np.asarray(ref["idx"])[:T, :E].astype(int))
        assert d.max(initial=0) <= 1, f"lane {j}: {d.max()} bins apart"
        with np.errstate(all="ignore"):
            on = chip_smoke.boundary_mask(got[j], float(ref["vmin"]), float(case["z_bounds"][j, 1]), z, d > 0)
        assert on.sum() == (d > 0).sum(), f"lane {j}: {(d > 0).sum() - on.sum()} cells off a bin boundary"


def test_xla_flushes_subnormals_and_the_port_keeps_them():
    """Why the parity cases flush subnormals: XLA:CPU reads them as zero; numpy and the port do not."""
    from configurable_spectrograms_tpu.ops.spectrogram import collapse_cube as jax_collapse
    from configurable_spectrograms_torch.render.host_quantize import host_collapse

    cube = np.zeros((64, 2, 128), np.float32)
    cube[:, 0], cube[:, 1] = np.float32(1e-39), np.float32(2e-39)
    mask = np.ones(2, bool)
    port = K.collapse_lanes(*(torch.from_numpy(a) for a in (cube[None], np.zeros(1, np.int32), mask[None],
                                                             np.array([64], np.int32))))[0].numpy()
    np.testing.assert_array_equal(port, host_collapse(cube, mask))
    assert port[0, 0] == np.float32(1e-39) + np.float32(2e-39)
    assert not np.asarray(jax_collapse(jnp.asarray(cube), jnp.asarray(mask), 64)).any()


def test_fused_safe_floor_takes_a_value_at_or_above_the_sentinel(monkeypatch):
    """The fault the sweep found: a window whose only finite positive cells are >= 3e38.

    ``_analyze_matrix`` (the JAX package's device route) floors a log panel's
    vmin at min(those cells, 3e38); the port's fused route took them for no
    value at all (the 1e-10 floor, as ``fused_quantize_pallas`` still does)
    and rendered the panel where the JAX package renders another ramp (or
    raises, when the floor passes vmax).  Both packages' device renders of
    the same panels, on the CPU, must agree on vmin and on the error.
    """
    import dataclasses

    from configurable_spectrograms_tpu.render import dispatch as jax_dispatch
    from configurable_spectrograms_tpu.render import link
    from configurable_spectrograms_tpu.render.panel import PanelData as JaxPanel
    from configurable_spectrograms_tpu.render.tile import TimeWindow as JaxWindow
    from configurable_spectrograms_torch.render.dispatch import device_render_panels
    from configurable_spectrograms_torch.render.panel import PanelData
    from configurable_spectrograms_torch.render.tile import compute_time_window

    T, A, E = 64, 4, 16
    cube = np.full((T, A, E), -1.0, np.float32)
    cube[10, :2, 3] = np.float32(1.6e38)  # pitch sum 3.2e38: finite, positive, above the sentinel
    times = np.arange(T, dtype=np.float64)
    energy = np.geomspace(10.0, 1e4, E)
    panels = [
        PanelData(cube=cube, pitch_mask=np.ones(A, bool), energy=energy, times=times,
                  window=compute_time_window(times), y_min=10.0, y_max=1e4, z_min=zmin, z_max=zmax,
                  y_scale="log", z_scale="log", colormap="inferno", x_is_unix=False, z_label="")
        for zmin, zmax in ((2.0, 3.3e38), (2.0, 100.0))
    ]
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    port = device_render_panels(panels, 16, 24)
    mode = link._BACKEND["mode"]
    link._BACKEND["mode"] = "device"
    try:
        jax_panels = [JaxPanel(**{**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)},
                                  "window": JaxWindow(**dataclasses.asdict(p.window))}) for p in panels]
        ref = jax_dispatch.device_render_panels(jax_panels, 16, 24)
    finally:
        link._BACKEND["mode"] = mode
    assert port[0]["vmin"] == ref[0]["vmin"] == np.float32(3e38)
    assert port[1].get("error") == ref[1].get("error") == "minvalue must be less than or equal to maxvalue"


def _scalars(r: dict) -> tuple:
    if "error" in r:
        return ("error", r["error"])
    return tuple(np.float32(r[k]).tobytes() for k in ("vmin", "vmax", "y0", "y1", "n_kept", "empty"))


@pytest.mark.parametrize("seed", [28, 47, 192])
def test_backend_divergences_follow_the_jax_package(seed, monkeypatch):
    """The panels whose device and host renders differ in the sweep's end-to-end check differ so in the JAX package.

    A percentile pool of one cell or of infinities: the host returns NaN
    bounds, the device 3e38 / inf or LogNorm's error.  The port's device
    render of each such panel matches the JAX package's device render, and
    its host render the JAX package's host render (ROADMAP C).
    """
    import dataclasses

    from configurable_spectrograms_tpu.render import dispatch as jax_dispatch
    from configurable_spectrograms_tpu.render import link
    from configurable_spectrograms_tpu.render.panel import PanelData as JaxPanel
    from configurable_spectrograms_tpu.render.tile import TimeWindow as JaxWindow
    from configurable_spectrograms_torch.render.dispatch import device_render_panels

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    panels = chip_smoke.sweep_panels(chip_smoke.sweep_case(seed, max_cells=1 << 20))
    port = {}
    for backend in ("device", "host"):
        monkeypatch.setenv("CST_RENDER_BACKEND", backend)
        port[backend] = device_render_panels(panels, 48, 64)
    divergent = []
    for i, p in enumerate(panels):
        try:
            chip_smoke.compare_panels([(48, 64, p)], [port["device"][i]], [port["host"][i]], window_only=True)
        except AssertionError:
            divergent.append(i)
    assert divergent, "no panel of this seed diverges any more: drop it here and from ROADMAP C"
    picked = [JaxPanel(**{**{f.name: getattr(panels[i], f.name) for f in dataclasses.fields(panels[i])},
                          "window": JaxWindow(**dataclasses.asdict(panels[i].window))}) for i in divergent]
    mode = link._BACKEND["mode"]
    try:
        for backend in ("device", "host"):
            link._BACKEND["mode"] = backend
            ref = jax_dispatch.device_render_panels(picked, 48, 64)
            for i, r in zip(divergent, ref):
                assert _scalars(port[backend][i]) == _scalars(r), f"panel {i}, {backend} backend"
    finally:
        link._BACKEND["mode"] = mode
