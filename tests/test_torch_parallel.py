"""The port's parallel layer against the JAX package's, on the CPU.

Two-rank Gloo groups (spawned processes, :func:`configurable_spectrograms_torch.entry.spawn_ranks`)
run ``sharded_extrema_stats`` and ``sharded_batch_render`` on the same
seeded numpy inputs that the JAX package's functions see on its 8-device
virtual CPU mesh (tests/conftest.py): the extrema stats must agree bit for
bit on a ``('data',)`` mesh of 2 and a ``('data', 'time')`` mesh of 1x2
(A <= 32, where XLA:CPU adds the pitch bins in index order), the render's
bounds bit for bit and its tiles exactly.  A two-rank flagship run must
write, between its ranks, the PNGs of a one-process run (decoded pixels)
and the same extrema JSON in each rank.  Then ``init_distributed``,
``make_mesh``'s errors, ``get_device``'s index, the kernels' device
guards, ``entry()`` against ``__graft_entry__.entry()`` and the dry run.

The rank functions below are module-level (a spawned rank imports them by
name) and the module imports no JAX at its top: the ranks import this
module and nothing of the JAX package.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_slice import _assert_same_pixels

REPO = Path(__file__).resolve().parents[1]
N_FILES, T_ROWS, A_PITCH, E_BINS = 4, 32, 16, 12
N_PANELS, T_PANEL, A_PANEL, E_PANEL, H_TILE, W_TILE = 4, 40, 8, 12, 32, 64
CROP = (28, 60)  # out_h, out_w inside the H_TILE x W_TILE tile

torch.set_num_threads(1)


@pytest.fixture
def cpu_ranks(monkeypatch):
    """Ranks spawned from this test compute on the CPU, one thread each."""
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


#: Seeds of the extrema inputs: no collapsed value within two float32 ulps of a histogram bin edge (exact
#: against the JAX package), and one with such a value (XLA's fused program may bin it one bin apart).
EXACT_SEED, EDGE_SEED = 12, 11


def extrema_inputs(seed=EXACT_SEED):
    rng = np.random.default_rng(seed)
    cubes = (rng.random((N_FILES, T_ROWS, A_PITCH, E_BINS)) * 50 - 5).astype(np.float32)
    cubes[rng.random(cubes.shape) < 0.1] = np.nan
    cubes[rng.random(cubes.shape) < 0.002] = np.inf
    t_valids = np.array([T_ROWS, 9, 20, 17], np.int32)  # rows past t_valid hold data the stats must skip
    return cubes, t_valids


def render_inputs():
    from configurable_spectrograms_torch.ops._colormap_data import colormap_lut

    rng = np.random.default_rng(12)
    N, T, A, E = N_PANELS, T_PANEL, A_PANEL, E_PANEL
    cubes = (rng.random((N, T, A, E)) * 100).astype(np.float32)
    cubes[rng.random(cubes.shape) < 0.05] = np.nan
    masks = rng.random((N, A)) < 0.7
    masks[:, 0] = True
    z_bounds = np.full((N, 2), np.nan, np.float32)
    z_bounds[1] = (5.0, 300.0)
    t_valids = np.array([T, 33, T, 25], np.int32)
    return dict(
        cubes=cubes,
        pitch_masks=masks,
        t_valids=t_valids,
        energies=np.tile(np.geomspace(4000, 10, E).astype(np.float32), (N, 1)),
        e_valids=np.ones((N, E), bool),
        t_starts=np.array([0, 3, 5, 0], np.int32),
        t_counts=np.array([T, 25, 30, 25], np.int32),
        x_maps=np.tile(np.array([T / W_TILE, 0.5 * T / W_TILE], np.float32), (N, 1)),
        z_bounds=z_bounds,
        luts=np.stack([colormap_lut(c) for c in ("inferno", "viridis", "plasma", "cividis")]),
    )


SPEC = (H_TILE, W_TILE, "log", "log")


def _collectives_rank(rank, render_args):
    """Every collective of the layer in one two-rank group, and the errors it must raise."""
    from configurable_spectrograms_torch.ops import kernels
    from configurable_spectrograms_torch.ops.spectrogram import RenderSpec
    from configurable_spectrograms_torch.parallel import make_mesh, sharded_batch_render, sharded_extrema_stats
    from configurable_spectrograms_torch.parallel.mesh import data_parallel_mesh, global_file_batch

    calls = {"collapse": 0}
    plain = kernels.collapse_lanes_plain

    def counted(*a):  # CPU tensors launch nothing; count the calls that would have
        calls["collapse"] += 1
        return plain(*a)

    kernels.collapse_lanes_plain = counted
    out = {"rank": rank}
    data = make_mesh(2)
    data_time = make_mesh(2, ("data", "time"), (1, 2))
    mine = slice(2 * rank, 2 * rank + 2)
    for seed in (EXACT_SEED, EDGE_SEED):
        cubes, t_valids = extrema_inputs(seed)
        out[seed, "data"] = sharded_extrema_stats(cubes, t_valids, data)
        out[seed, "data_time"] = sharded_extrema_stats(cubes, t_valids, data_time)
        local = global_file_batch(cubes[mine], t_valids[mine], data)
        out[seed, "local_stack"] = sharded_extrema_stats(local, None, data)
    out["collapse_calls"] = calls["collapse"]
    dp = data_parallel_mesh()
    out["data_parallel_mesh"] = (dp.mesh_dim_names, dp.size(), dp.get_local_rank("data"))
    spec = RenderSpec(*SPEC)
    out["render"] = sharded_batch_render(data, spec, **render_args)
    out["render_cropped"] = sharded_batch_render(data, spec, **render_args, out_h=CROP[0], out_w=CROP[1])
    errors = []
    for bad in (
        lambda: make_mesh(3),
        lambda: make_mesh(2, ("data", "time"), (2, 2)),
        lambda: sharded_batch_render(data, spec, **{k: v[:3] for k, v in render_args.items()}),
    ):
        try:
            bad()
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def two_rank_results(tmp_path_factory):
    from configurable_spectrograms_torch.entry import spawn_ranks

    env = {"CST_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return spawn_ranks(_collectives_rank, 2, "gloo", args=(render_inputs(),), timeout=300)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _jax_extrema(seed, layout):
    from configurable_spectrograms_tpu.parallel import make_mesh, sharded_extrema_stats

    mesh = make_mesh(2) if layout != "data_time" else make_mesh(2, ("data", "time"), (1, 2))
    return sharded_extrema_stats(*extrema_inputs(seed), mesh)


def _positives(seed) -> np.ndarray:
    """The positive finite collapsed values the stats pool (float32, numpy's in-order sum)."""
    cubes, t_valids = extrema_inputs(seed)
    collapsed = np.where(np.isnan(cubes), np.float32(0.0), cubes).sum(axis=2, dtype=np.float32)
    in_file = np.arange(T_ROWS)[None, :, None] < t_valids[:, None, None]
    return collapsed[in_file & np.isfinite(collapsed) & (collapsed > 0)]


def _edge_moves(got: np.ndarray, want: np.ndarray, seed) -> int:
    """Values that one histogram holds one bin from the other; fails unless each sits on a bin edge.

    The edge rule of docs/parity.md:93-127 for the histogram: a value whose
    float64 bin position lies within one float32 ulp of an edge may land
    on either side of it (XLA's fused float32 ``log10`` and binning against
    torch's).  ``cumsum(got - want)[b - 1]`` is the net count moved across
    the edge below bin ``b``; it must be zero except at such edges, and no
    larger than the values sitting there.
    """
    from configurable_spectrograms_torch.ops.extrema_ops import HIST_BINS, LOG_HI, LOG_LO

    pos = (np.log10(_positives(seed).astype(np.float64)) - LOG_LO) / (LOG_HI - LOG_LO) * HIST_BINS
    edge = np.rint(pos)
    on_edge = np.abs(pos - edge) <= np.spacing(pos.astype(np.float32)).astype(np.float64)
    at = {int(b): int(n) for b, n in zip(*np.unique(edge[on_edge], return_counts=True))}
    moved = np.cumsum(got.astype(np.int64) - want.astype(np.int64))
    assert moved[-1] == 0
    for b in np.nonzero(moved)[0]:
        assert abs(int(moved[b])) <= at.get(int(b) + 1, 0), f"bin {b} and {b + 1} differ away from an edge"
    return int(np.abs(moved).sum())


@pytest.mark.parametrize("layout", ["data", "data_time", "local_stack"])
def test_sharded_extrema_stats_equal_the_jax_package(layout, two_rank_results):
    want_counts, want_hist = _jax_extrema(EXACT_SEED, layout)
    assert want_hist.sum() == _positives(EXACT_SEED).size > 0 and (want_counts < T_ROWS).any()
    for r in two_rank_results:
        counts, hist = r[EXACT_SEED, layout]
        assert counts.dtype == np.int32 and hist.dtype == np.int64
        np.testing.assert_array_equal(counts, want_counts, err_msg=f"rank {r['rank']} counts")
        np.testing.assert_array_equal(hist, want_hist, err_msg=f"rank {r['rank']} hist")


@pytest.mark.parametrize("layout", ["data", "data_time", "local_stack"])
def test_sharded_extrema_stats_on_a_bin_edge(layout, two_rank_results):
    """A value on a bin edge: counts exact; the histogram exactly the JAX package's numpy stats, and the
    JAX package's sharded one but for that value one bin apart."""
    from configurable_spectrograms_tpu.ops.extrema_ops import host_file_stats

    cubes, t_valids = extrema_inputs(EDGE_SEED)
    host = [host_file_stats(cubes[i, : t_valids[i]]) for i in range(N_FILES)]
    want_counts, want_hist = _jax_extrema(EDGE_SEED, layout)
    for r in two_rank_results:
        counts, hist = r[EDGE_SEED, layout]
        np.testing.assert_array_equal(counts, want_counts)
        np.testing.assert_array_equal(counts, np.stack([h["counts"] for h in host]))
        np.testing.assert_array_equal(hist, np.sum([h["hist"] for h in host], axis=0))
        assert _edge_moves(hist, want_hist, EDGE_SEED) <= 1


def test_sharded_extrema_stats_run_on_the_collapse_kernel(two_rank_results):
    """Each rank reduces its block with the collapse kernel's wrapper: one call per mesh and input."""
    assert [r["collapse_calls"] for r in two_rank_results] == [6, 6]


@pytest.mark.parametrize("crop", [False, True])
def test_sharded_batch_render_matches_the_jax_package(crop, two_rank_results):
    from configurable_spectrograms_tpu.ops import RenderSpec
    from configurable_spectrograms_tpu.parallel import make_mesh, sharded_batch_render

    size = dict(zip(("out_h", "out_w"), CROP)) if crop else {}
    want = sharded_batch_render(make_mesh(2), RenderSpec(*SPEC), **render_inputs(), **size)
    for r in two_rank_results:
        got = r["render_cropped" if crop else "render"]
        assert set(got) == set(want)
        for k in ("vmin", "vmax", "y0", "y1", "n_kept", "empty"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"rank {r['rank']} {k}")
            assert got[k].dtype == want[k].dtype, k
        assert got["rgba"].dtype == np.uint8 and got["rgba"].shape == (N_PANELS, H_TILE, W_TILE, 4)
        np.testing.assert_array_equal(got["rgba"], want["rgba"], err_msg=f"rank {r['rank']} rgba")
    if crop:  # the padding is background in both
        assert (want["rgba"][:, : H_TILE - CROP[0]] == 255).all() and (want["rgba"][:, :, CROP[1]:] == 255).all()


def test_mesh_and_batch_errors_match_the_jax_package(two_rank_results):
    for r in two_rank_results:
        too_many, bad_sizes, not_a_multiple = r["errors"]
        assert too_many == "requested 3 devices but only 2 available"
        assert bad_sizes == "axis sizes (2, 2) do not multiply to 2"
        assert not_a_multiple == "panel batch (3) must be a multiple of the data axis (2)"


def test_data_parallel_mesh_spans_the_group(two_rank_results):
    """One ``('data',)`` axis over both ranks in a group; ``None`` with no group."""
    from configurable_spectrograms_torch.parallel.mesh import data_parallel_mesh

    assert [r["data_parallel_mesh"] for r in two_rank_results] == [(("data",), 2, 0), (("data",), 2, 1)]
    assert data_parallel_mesh() is None


def test_process_shard_info_and_padding_match_the_jax_package():
    from configurable_spectrograms_tpu.parallel import mesh as jmesh

    from configurable_spectrograms_torch.parallel import mesh

    for shard in ((2, 3), (0, 1)):
        jmesh.set_process_shard(*shard)
        mesh.set_process_shard(*shard)
        assert mesh.process_shard_info() == jmesh.process_shard_info() == shard
    for n, m in ((0, 4), (1, 4), (4, 4), (5, 4), (9, 2), (7, 1)):
        assert mesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


def test_make_mesh_raises_without_enough_ranks():
    from configurable_spectrograms_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        make_mesh(2)
    with pytest.raises(ValueError, match="do not multiply"):
        make_mesh(1, ("data", "time"), (2, 1))
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh()


def test_init_distributed_forwards_arguments(monkeypatch):
    """test_parallel.py::test_init_distributed_forwards_arguments: only the arguments given reach
    ``init_process_group`` (torchrun's environment otherwise)."""
    import torch.distributed as dist

    from configurable_spectrograms_torch.parallel import mesh

    calls = []
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    try:
        mesh.init_distributed()
        mesh.init_distributed(coordinator_address="h:1234", num_processes=4, process_id=1)
        mesh.init_distributed(backend="nccl")
        assert mesh._DISTRIBUTED == {"process_id": 1, "num_processes": 4, "local_rank": 0}
    finally:
        mesh.shutdown_distributed()
    assert calls == [
        {"backend": "gloo"},
        {"backend": "gloo", "init_method": "tcp://h:1234", "world_size": 4, "rank": 1},
        {"backend": "nccl"},
    ]
    assert mesh._DISTRIBUTED == {"process_id": 0, "num_processes": 1, "local_rank": None}


def test_get_device_names_the_rank_s_card(monkeypatch):
    """``cuda:{local rank}`` under a recorded group, ``cuda:0`` without one, never the index-less ``cuda``."""
    from configurable_spectrograms_torch.parallel import mesh
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("CST_TORCH_DEVICE", "cuda")
    assert get_device() == torch.device("cuda", 0) and get_device().index == 0
    monkeypatch.setitem(mesh._DISTRIBUTED, "local_rank", 1)
    assert get_device() == torch.device("cuda", 1)
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    assert get_device() == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CST_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        get_device()


def test_every_kernel_launch_runs_under_its_tensors_device():
    """Each ``cst_*`` call of ops/kernels.py sits inside ``with torch.cuda.device(...)``."""
    tree = ast.parse((REPO / "configurable_spectrograms_torch" / "ops" / "kernels.py").read_text())
    guarded, launches = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(ast.unparse(i.context_expr).startswith("torch.cuda.device(")
                                              for i in node.items):
            guarded |= {id(n) for n in ast.walk(node)}
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr.startswith("cst_"):
            launches.append(node)
    assert sorted(n.func.attr for n in launches) == ["cst_collapse", "cst_fused_quantize", "cst_percentile_quantize",
                                                      "cst_stft_power"]
    assert all(id(n) in guarded for n in launches), [n.func.attr for n in launches if id(n) not in guarded]


def _flagship_rank(rank, data, out):
    from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_directory

    results = FAST_plot_spectrograms_directory(
        data, output_base=os.path.join(out, "plots"), y_scale="log", z_scale="log", colormap="inferno",
        max_workers=1, progress_json_path=os.path.join(out, "progress.json"),
        extrema_json_path=os.path.join(out, "extrema.json"), max_processing_percentile=95, retry_timeouts=False,
        use_tqdm=False, orbit_timeout_seconds=600, instrument_timeout_seconds=300, verbose=False)
    return sorted((int(r["orbit"]), r["status"]) for r in results)


def test_two_rank_flagship_writes_the_one_process_pngs(tmp_path, cpu_ranks, monkeypatch):
    import json

    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive
    from configurable_spectrograms_torch.entry import spawn_ranks

    synth_fast_archive(str(tmp_path / "data"), [3001, 3002], n_time=256, n_angle=16, n_energy=24,
                       cusp_csv_path=str(tmp_path / "cusp.tsv"), seed=9)
    monkeypatch.setenv("CST_CUSP_CSV", str(tmp_path / "cusp.tsv"))
    monkeypatch.setenv("CST_FAST_SAVE_DPI", "60")
    runs = {}
    for n in (1, 2):
        out = tmp_path / f"ranks{n}"
        out.mkdir()  # the drivers write their state files into an existing directory
        runs[n] = spawn_ranks(_flagship_rank, n, "gloo", args=(str(tmp_path / "data"), str(out)), timeout=300)
    assert runs[1] == [[(3001, "ok"), (3001, "ok"), (3002, "ok"), (3002, "ok")]]  # raw and given-extrema runs
    assert runs[2] == [[(3001, "ok"), (3001, "ok")], [(3002, "ok"), (3002, "ok")]]  # orbits r::n
    one = {p.relative_to(tmp_path / "ranks1"): p for p in (tmp_path / "ranks1").rglob("*.png")}
    two = {p.relative_to(tmp_path / "ranks2"): p for p in (tmp_path / "ranks2").rglob("*.png")}
    assert len(one) == 20 and sorted(two) == sorted(one)
    for rel, path in one.items():
        _assert_same_pixels(path.read_bytes(), two[rel].read_bytes(), str(rel))
    ex = [json.loads((tmp_path / "ranks2" / f"extrema.json.proc{r}").read_text()) for r in (0, 1)]
    assert ex[0] == ex[1] == json.loads((tmp_path / "ranks1" / "extrema.json").read_text())
    assert not (tmp_path / "ranks2" / "extrema.json").exists()
    assert sorted(p.name for p in (tmp_path / "ranks2").glob("progress.json*")) == [
        "progress.json.proc0", "progress.json.proc1"]


def test_entry_forward_matches_the_graft_entry():
    """The port's ``entry()`` forward (CPU, plain kernels) against ``__graft_entry__.entry()`` under ``jax.jit``."""
    import jax

    import __graft_entry__
    from configurable_spectrograms_torch.entry import entry, entry_arrays

    jfn, jargs = __graft_entry__.entry()
    for a, b in zip(entry_arrays(), jargs):
        np.testing.assert_array_equal(a, b)
    want = [np.asarray(x) for x in jax.jit(jfn)(*jargs)]
    fn, args = entry(torch.device("cpu"))
    assert all(a.device.type == "cpu" for a in args)
    rgba, vmin, vmax = (x.numpy() for x in fn(*args))
    assert rgba.shape == (128, 256, 4) and rgba.dtype == np.uint8
    np.testing.assert_array_equal(vmin, want[1])
    np.testing.assert_array_equal(vmax, want[2])
    np.testing.assert_array_equal(rgba, want[0])


def test_dryrun_multichip_two_gloo_ranks_on_the_cpu(cpu_ranks):
    """test_graft_entry.py::test_dryrun_multichip_eight and test_graft_entry.py::test_ensure_devices_provisions_virtual_cpus.

    The dry run starts its own ranks, one Gloo rank per device, from a
    process with no group: the port's counterpart of XLA's virtual CPU
    devices.  Two ranks here, as everywhere in this file, where the JAX
    tests ask for eight and four devices.
    """
    from configurable_spectrograms_torch.entry import dryrun_multichip

    records = dryrun_multichip(2, "gloo")
    assert [(r["rank"], r["device"], r["orbits"]) for r in records] == [(0, "cpu", [4100]), (1, "cpu", [4101])]


def _failing_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def test_spawn_ranks_reports_a_failed_rank_and_stops_the_others(cpu_ranks):
    from configurable_spectrograms_torch.entry import spawn_ranks

    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(_failing_rank, 2, "gloo", timeout=120)
