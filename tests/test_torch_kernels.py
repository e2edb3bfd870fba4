"""The port's kernel modules against the JAX package, on the CPU.

On the CPU every kernel wrapper runs its plain PyTorch version, so these
tests pin the arithmetic the CUDA kernels are held to on the card
(``chip_smoke.py`` compares kernel and plain version there).  Inputs come
from numpy seeds and go through both packages; JAX runs on its CPU
backend, and the Pallas kernels through the Pallas interpreter, as the JAX
package's own tests run them.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from configurable_spectrograms_torch.ops import kernels as K  # noqa: E402
from configurable_spectrograms_torch.ops.spectrogram import collapse_cube  # noqa: E402

torch.set_num_threads(1)

F32_EPS = float(np.finfo(np.float32).eps)


def _cube(seed: int, T: int, A: int, E: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    cube = (rng.random((T, A, E)) * 1e3).astype(np.float32)
    cube[rng.random(cube.shape) < 0.1] = np.nan
    cube[rng.random(cube.shape) < 0.002] = np.inf
    cube[rng.random(cube.shape) < 0.002] = -np.inf
    cube[rng.random(cube.shape) < 0.05] *= -1.0
    mask = rng.random(A) < 0.6
    mask[0] = True
    return cube, mask


def _lanes(cube, masks, t_valids):
    L = len(masks)
    return (
        torch.from_numpy(cube[None]),
        torch.zeros((L,), dtype=torch.int32),
        torch.from_numpy(np.stack(masks)),
        torch.tensor(t_valids, dtype=torch.int32),
    )


def _same_with_nan(got: np.ndarray, want: np.ndarray) -> None:
    """Equal values (+0 == -0) with NaN in the same places."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("A", [8, 32, 64])
def test_plain_collapse_matches_host_collapse(A):
    """Index-order accumulation equals the numpy host oracle bit for bit, at every A."""
    from configurable_spectrograms_tpu.render.host_quantize import host_collapse

    cube, mask = _cube(A, 96, A, 40)
    got = K.collapse_lanes(*_lanes(cube, [mask, ~mask, np.ones(A, bool)], [96, 96, 70])).numpy()
    _same_with_nan(got[0], host_collapse(cube, mask))
    _same_with_nan(got[1], host_collapse(cube, ~mask))
    full = host_collapse(cube, np.ones(A, bool))
    full[70:] = np.nan
    _same_with_nan(got[2], full)


@pytest.mark.parametrize("A", [8, 32])
@pytest.mark.parametrize("t_valid", [128, 77])
def test_plain_collapse_matches_jax_exactly_up_to_a32(A, t_valid):
    """Against ``collapse_cube`` (XLA) and ``collapse_cube_pallas`` (interpreter)."""
    from configurable_spectrograms_tpu.ops.pallas_kernels import collapse_cube_pallas
    from configurable_spectrograms_tpu.ops.spectrogram import collapse_cube as jax_collapse

    cube, mask = _cube(100 + A, 128, A, 128)
    got = collapse_cube(torch.from_numpy(cube), torch.from_numpy(mask), t_valid).numpy()
    _same_with_nan(got, np.asarray(jax_collapse(jnp.asarray(cube), jnp.asarray(mask), t_valid)))
    _same_with_nan(got, np.asarray(collapse_cube_pallas(jnp.asarray(cube), jnp.asarray(mask), t_valid)))


@pytest.mark.parametrize("which", ["xla", "pallas"])
def test_plain_collapse_matches_jax_within_tolerance_at_a64(which):
    """At A = 64 XLA:CPU no longer adds the pitch slices in index order.

    Measured: against the index-order host collapse, ``collapse_cube`` differed
    in 4284 of 6144 cells at 128x64x48, by at most 1.7e-7 of sum|x|.  The
    port adds in index order (it must equal the numpy pool bit for bit), so
    against JAX each cell holds |a - b| <= 4 * eps * sum|x| instead of
    equality; NaN placement and infinities still match exactly.
    """
    from configurable_spectrograms_tpu.ops.pallas_kernels import collapse_cube_pallas
    from configurable_spectrograms_tpu.ops.spectrogram import collapse_cube as jax_collapse

    A = 64
    cube, mask = _cube(7, 128, A, 128)
    fn = jax_collapse if which == "xla" else collapse_cube_pallas
    want = np.asarray(fn(jnp.asarray(cube), jnp.asarray(mask), 100))
    got = collapse_cube(torch.from_numpy(cube), torch.from_numpy(mask), 100).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    mag = np.where(np.isnan(cube) | ~mask[None, :, None], 0.0, np.abs(cube.astype(np.float64))).sum(axis=1)
    assert np.all(np.abs(got[finite].astype(np.float64) - want[finite]) <= 4 * F32_EPS * mag[finite])


def _assert_fused_contract(got: dict, want: dict, cube, mask, t_valid, z_scale, zb) -> None:
    """vmin and col_all_nan exact; idx exact except provable bin-boundary cells.

    The contract of docs/parity.md:93-127: a cell may differ by one bin only
    where float64 recomputation puts norm * 256 within a few float32 ulps of
    an integer (two float32 log10 implementations disagree there).
    """
    assert float(got["vmin"]) == float(want["vmin"])
    np.testing.assert_array_equal(got["col_all_nan"], want["col_all_nan"])
    diff = got["idx"] != want["idx"]
    if not diff.any():
        return
    assert int(np.abs(got["idx"].astype(int) - want["idx"].astype(int)).max()) <= 1
    m = np.where(np.isnan(cube) | ~mask[None, :, None], 0.0, cube).sum(axis=1, dtype=np.float32)
    m[t_valid:] = np.nan
    vmin, vmax = float(want["vmin"]), float(zb[1])
    m64 = m.astype(np.float64)
    if z_scale == "log":
        w = np.where(~np.isfinite(m64) | (m64 <= 0), vmin, m64)
        bins = (np.log10(w) - np.log10(vmin)) / (np.log10(vmax) - np.log10(vmin)) * 256.0
        tol = 256.0 * 6.0 * float(np.spacing(np.float32(max(abs(np.log10(vmin)), abs(np.log10(vmax)), 8.0)))) / (
            np.log10(vmax) - np.log10(vmin))
    else:
        w = np.where(np.isposinf(m64), vmax, np.where(np.isnan(m64) | np.isneginf(m64), vmin, m64))
        bins = (w - vmin) / (vmax - vmin) * 256.0
        tol = max(1e-4, float(np.abs(bins[diff]).max()) * 6.0e-7)
    assert np.all(np.abs(bins - np.rint(bins))[diff] <= tol), "idx differs away from a bin boundary"


@pytest.mark.parametrize("z_scale", ["log", "linear"])
@pytest.mark.parametrize(
    "A,window,bounds",
    [
        pytest.param(16, (0, 256), "given", id="16-window0"),
        pytest.param(32, (60, 120), "given", id="32-window1"),
        # A window past the file rows: no finite positive cell, so log z takes the 1e-10 floor.
        pytest.param(16, (240, 16), "no_positive", id="16-no_positive"),
        # vmax at the window's least positive cell: the safe floor raises vmin to vmax.
        pytest.param(16, (0, 256), "floor_at_vmax", id="16-floor_at_vmax"),
    ],
)
def test_plain_fused_matches_pallas_interpreter(z_scale, A, window, bounds):
    from configurable_spectrograms_tpu.ops.pallas_kernels import fused_quantize_pallas

    T, E, t_valid = 256, 128, 230
    cube, mask = _cube(3 * A, T, A, E)
    cube = np.abs(cube)  # a log panel of counts; negatives ride in _cube's NaN/inf cells
    cube[5, 0, 7] = np.inf
    cube[6, 0, 9] = -np.inf
    e_valid = np.random.default_rng(A).random(E) < 0.9
    t_start, t_count = window
    zb = np.array([2.0, 5000.0], np.float32)
    if bounds == "no_positive":
        zb[0] = 1e-12
    elif bounds == "floor_at_vmax":
        m = K.collapse_lanes_plain(*_lanes(cube, [mask], [t_valid]))[0].numpy()
        rows = np.arange(T)[:, None]
        fp = np.isfinite(m) & (m > 0) & (rows >= t_start) & (rows < t_start + t_count) & e_valid[None, :]
        minpos = m[fp].min()
        zb[:] = (minpos / 4, minpos)
    ref = fused_quantize_pallas(jnp.asarray(cube), jnp.asarray(mask), jnp.asarray(e_valid), t_valid,
                                t_start, t_count, jnp.asarray(zb), z_scale=z_scale)
    out = K.fused_quantize_lanes(
        torch.from_numpy(cube[None]), torch.zeros((1,), dtype=torch.int32),
        torch.from_numpy(mask[None]), torch.from_numpy(e_valid[None]),
        torch.tensor([t_valid], dtype=torch.int32), torch.tensor([t_start], dtype=torch.int32),
        torch.tensor([t_count], dtype=torch.int32), torch.from_numpy(zb[None]), z_scale=z_scale,
    )
    got = {"idx": out["idx"][0].numpy(), "vmin": out["vmin"][0].item(), "col_all_nan": out["col_all_nan"][0].numpy()}
    want = {k: np.asarray(v) for k, v in ref.items()}
    _assert_fused_contract(got, want, cube, mask, t_valid, z_scale, zb)
    if z_scale == "log" and bounds == "no_positive":
        assert got["vmin"] == np.float32(1e-10)
    if z_scale == "log" and bounds == "floor_at_vmax":
        assert got["vmin"] == zb[1] and not got["idx"].any()


def _fused_layout(u_idx: list[int], seed: int, T: int = 64, A: int = 16, E: int = 24) -> dict:
    """fused_quantize_lanes arguments: lanes on two cubes by *u_idx*, each with its own mask, window and bounds."""
    rng = np.random.default_rng(seed)
    cube, mask = _cube(seed, T, A, E)
    cubes = np.abs(np.stack([cube, cube[::-1] * np.float32(1.5)]))
    L = len(u_idx)
    masks = np.stack([[mask, ~mask, np.ones(A, bool)][j % 3] for j in range(L)])
    t_valid = rng.integers(T // 2, T + 1, L).astype(np.int32)
    t_start = rng.integers(0, T // 2, L).astype(np.int32)
    t_count = rng.integers(0, T // 2, L).astype(np.int32)
    lo = rng.uniform(0.5, 5.0, L).astype(np.float32)
    return dict(
        cubes=torch.from_numpy(cubes), u_idx=torch.tensor(u_idx, dtype=torch.int32), masks=torch.from_numpy(masks),
        e_valid=torch.from_numpy(rng.random((L, E)) < 0.8), t_valid=torch.from_numpy(t_valid),
        t_start=torch.from_numpy(t_start), t_count=torch.from_numpy(t_count),
        z_bounds=torch.from_numpy(np.stack([lo, lo * 300.0], axis=1)),
    )


@pytest.mark.parametrize("u_idx", [[0] * 3, [0, 1, 0, 1, 1, 0, 1, 0], [0] * 11],
                         ids=["3_lanes", "two_cubes_interleaved", "11_lanes"])
def test_fused_lanes_are_independent(u_idx):
    """Lanes of one launch share cubes but keep their own mask, window and bounds."""
    args = _fused_layout(u_idx, seed=11)
    both = K.fused_quantize_lanes(**args)
    for j in range(len(u_idx)):
        one = K.fused_quantize_lanes(**{k: (v[j: j + 1] if k != "cubes" else v) for k, v in args.items()})
        assert torch.equal(both["idx"][j], one["idx"][0])
        assert torch.equal(both["vmin"][j], one["vmin"][0])
        assert torch.equal(both["col_all_nan"][j], one["col_all_nan"][0])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    cube, mask = _cube(5, 32, 8, 16)
    before = dict(K.LAUNCHES)
    got = K.collapse_lanes(*_lanes(cube, [mask], [32]))
    want = K.collapse_lanes_plain(*_lanes(cube, [mask], [32]))
    _same_with_nan(got.numpy(), want.numpy())
    assert K.LAUNCHES == before


@pytest.mark.parametrize(
    "bad",
    [
        lambda c, u, m, t: (c.double(), u, m, t),
        lambda c, u, m, t: (c, u.long(), m, t),
        lambda c, u, m, t: (c, u, m[:, :-1], t),
        lambda c, u, m, t: (c, u, m.to(torch.uint8), t),
        lambda c, u, m, t: (c, u, m, t[:0]),
    ],
)
def test_wrapper_rejects_inputs_the_kernel_does_not_take(bad):
    cube, mask = _cube(5, 32, 8, 16)
    with pytest.raises(ValueError):
        K.collapse_lanes(*bad(*_lanes(cube, [mask], [32])))


def test_wrapper_rejects_unknown_z_scale():
    cube, mask = _cube(5, 32, 8, 16)
    c, u, m, t = _lanes(cube, [mask], [32])
    with pytest.raises(ValueError):
        K.fused_quantize_lanes(c, u, m, torch.ones((1, 16), dtype=torch.bool), t, t * 0, t,
                               torch.tensor([[1.0, 2.0]]), z_scale="sqrt")


@pytest.mark.parametrize(
    "u_idx",
    [
        [0] * 8,
        [0] * 11,
        [0, 1, 0, 1, 1, 0, 1, 0],
        [3, 2, 1, 0],
        list(np.random.default_rng(4).integers(0, 5, 60)),
        [],
    ],
)
def test_lane_groups_cover_every_lane_once_by_cube(u_idx):
    """The collapse kernel's grouping rule: one cube a group, at most G lanes, lanes in index order."""
    G = K.COLLAPSE_GROUP
    u = np.asarray(u_idx, np.int32)
    groups = K.lane_groups(torch.from_numpy(u))
    lanes = [lane for g in groups for lane in g]
    assert sorted(lanes) == list(range(len(u)))  # every lane exactly once
    for g in groups:
        assert 1 <= len(g) <= G and len(set(u[g])) == 1
        assert g == sorted(g)
    # Stable: a cube's lanes, group after group, are its lanes in index order, and
    # only the last group of a cube may be short.
    for c in np.unique(u):
        mine = [g for g in groups if u[g[0]] == c]
        assert [lane for g in mine for lane in g] == list(np.flatnonzero(u == c))
        assert all(len(g) == G for g in mine[:-1])
    assert [g[0] for g in groups] == sorted(g[0] for g in groups)


def test_lane_groups_take_the_kernels_group_size():
    assert K.lane_groups(torch.zeros(20, dtype=torch.int32), 4) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11],
                                                                    [12, 13, 14, 15], [16, 17, 18, 19]]
    assert K.COLLAPSE_GROUP == 8  # CST_GROUP in csrc/collapse_common.cuh: one byte of lane bits a pitch bin


@pytest.mark.cuda
def test_cuda_collapse_layouts_match_the_plain_version():
    """On a card: two cubes with interleaved lanes, more lanes than a group, one all-pitch lane a cube."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cube, mask = _cube(10, 200, 32, 52)
    cubes = torch.from_numpy(np.stack([cube, cube[::-1] * 2.0])).cuda()
    layouts = [
        ([0, 1, 0, 1, 1, 0, 1, 0], [mask, ~mask] * 4),
        ([0] * 11, [mask, ~mask, np.ones(32, bool)] * 3 + [mask, mask]),
        ([0, 1], [np.ones(32, bool)] * 2),
    ]
    for u, masks in layouts:
        L = len(u)
        args = (cubes, torch.tensor(u, dtype=torch.int32).cuda(), torch.from_numpy(np.stack(masks)).cuda(),
                torch.tensor([200 - 13 * i for i in range(L)], dtype=torch.int32).cuda())
        _same_with_nan(K.collapse_lanes(*args).cpu().numpy(), K.collapse_lanes_plain(*args).cpu().numpy())
    # E % 4 != 0 takes the 4-byte path.
    args = [a.cuda() for a in _lanes(cube[:, :, :50].copy(), [mask, ~mask], [200, 150])]
    _same_with_nan(K.collapse_lanes(*args).cpu().numpy(), K.collapse_lanes_plain(*args).cpu().numpy())


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On a card: each kernel against its plain version (chip_smoke.py does this at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cube, mask = _cube(9, 300, 32, 48)
    args = [a.cuda() for a in _lanes(cube, [mask, ~mask], [300, 250])]
    _same_with_nan(K.collapse_lanes(*args).cpu().numpy(), K.collapse_lanes_plain(*args).cpu().numpy())
    cube = np.abs(cube)
    args = [a.cuda() for a in _lanes(cube, [mask, ~mask], [300, 250])]
    extra = [torch.ones((2, 48), dtype=torch.bool).cuda(), torch.tensor([0, 40], dtype=torch.int32).cuda(),
             torch.tensor([300, 100], dtype=torch.int32).cuda(), torch.tensor([[1.0, 900.0], [2.0, 50.0]]).cuda()]
    fused = (args[0], args[1], args[2], extra[0], args[3], extra[1], extra[2], extra[3])
    for z in ("log", "linear"):
        got, want = K.fused_quantize_lanes(*fused, z_scale=z), K.fused_quantize_lanes_plain(*fused, z_scale=z)
        assert torch.equal(got["vmin"], want["vmin"])
        assert torch.equal(got["col_all_nan"], want["col_all_nan"])
        assert int((got["idx"].int() - want["idx"].int()).abs().max()) <= 1


@pytest.mark.cuda
def test_cuda_fused_layouts_match_the_plain_version():
    """On a card: the fused kernel's lane layouts, each lane held to the contract of the plain version.

    Two cubes with interleaved lanes, 11 lanes on one cube (two groups),
    E = 50 (the 4-byte path), a lane with an empty window and a lane with no
    file rows (all NaN), in both z scales.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for u_idx, E in (([0, 1, 0, 1, 1, 0, 1, 0], 48), ([0] * 11, 48), ([0, 1, 0, 1, 1, 0, 1, 0], 50), ([0] * 11, 50)):
        args = _fused_layout(u_idx, seed=12, T=200, A=32, E=E)
        args["t_count"][1] = 0
        args["t_valid"][2] = 0
        args = {k: v.cuda() for k, v in args.items()}
        cubes = args["cubes"].cpu().numpy()
        for z in ("log", "linear"):
            got = K.fused_quantize_lanes(**args, z_scale=z)
            want = K.fused_quantize_lanes_plain(**args, z_scale=z)
            assert bool(want["col_all_nan"][2].all())
            for j, u in enumerate(u_idx):
                _assert_fused_contract(
                    {"idx": got["idx"][j].cpu().numpy(), "vmin": got["vmin"][j].item(),
                     "col_all_nan": got["col_all_nan"][j].cpu().numpy()},
                    {"idx": want["idx"][j].cpu().numpy(), "vmin": want["vmin"][j].item(),
                     "col_all_nan": want["col_all_nan"][j].cpu().numpy()},
                    cubes[u], args["masks"][j].cpu().numpy(), int(args["t_valid"][j]), z,
                    args["z_bounds"][j].cpu().numpy())


def test_get_device_honours_the_env_and_never_falls_back(monkeypatch):
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    assert get_device() == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setenv("CST_TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError):
        get_device()
    monkeypatch.setenv("CST_TORCH_DEVICE", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            get_device()


def test_render_backend_switch(monkeypatch):
    from configurable_spectrograms_torch.render.backend import render_backend

    monkeypatch.delenv("CST_RENDER_BACKEND", raising=False)
    assert render_backend() == "device"
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    assert render_backend() == "host"
    monkeypatch.setenv("CST_RENDER_BACKEND", "auto")
    with pytest.raises(ValueError):
        render_backend()
