"""Entry points: the single-device forward step and the multi-GPU dry run (port of ``__graft_entry__.py``).

``entry()`` returns the flagship forward step -- the fused collapse +
percentile bounds + normalise + extent resample + colormap LUT panel
rasterizer -- with example arguments shaped like one FAST instrument file,
on the port's device.

``dryrun_multichip(n, backend)`` starts ``n`` ranks (one process per
device, :func:`spawn_ranks`) and runs one full batch step in each: the
collective extrema reduction over a ``('data', 'time')`` mesh, then the
production batch driver on a synthetic archive, whose extrema pre-pass and
render must each have run on the rank's own device.

This module imports nothing of the port at import time: a spawned rank
imports it before its environment (``CST_TORCH_DEVICE``, ``LOCAL_RANK``)
is in place.
"""

from __future__ import annotations

import importlib
import os
import queue as queue_mod
import socket
import tempfile
import time
import traceback

import numpy as np

T_ENTRY, A_ENTRY, E_ENTRY = 128, 16, 24
H_ENTRY, W_ENTRY = 128, 256


def entry_arrays() -> tuple[np.ndarray, ...]:
    """The example arguments of ``__graft_entry__.entry`` (same seed, same arrays), as numpy."""
    from configurable_spectrograms_torch.ops._colormap_data import colormap_lut

    T, A, E, W = T_ENTRY, A_ENTRY, E_ENTRY, W_ENTRY
    rng = np.random.default_rng(0)
    cube = (rng.random((T, A, E)) * 100).astype(np.float32)
    pitch_mask = np.ones((A,), bool)
    energy = np.geomspace(30000, 4, E).astype(np.float32)
    e_valid = np.geomspace(30000, 4, E) <= 30000
    x_map = np.array([T / W, 0.5 * T / W], np.float32)
    z_bounds = np.array([np.nan, np.nan], np.float32)
    lut = np.asarray(colormap_lut("inferno"))
    return cube, pitch_mask, energy, e_valid, x_map, z_bounds, lut


def entry(device=None):
    """Return ``(fn, example_args)``: the forward step and its arguments on *device*.

    *device* defaults to :func:`..utils.torch_setup.get_device` (the card
    unless ``CST_TORCH_DEVICE=cpu``).  ``fn(*example_args)`` returns
    ``(rgba, vmin, vmax)``: the (128, 256, 4) uint8 tile and its colour
    bounds, computed on the arguments' device.
    """
    import torch

    from configurable_spectrograms_torch.ops.spectrogram import RenderSpec, collapse_cube, render_matrix
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    T = T_ENTRY
    spec = RenderSpec(height=H_ENTRY, width=W_ENTRY, y_scale="log", z_scale="log")
    dev = get_device() if device is None else torch.device(device)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in entry_arrays())

    def forward(cube, pitch_mask, energy, e_valid, x_map, z_bounds, lut):
        d = cube.device
        m = collapse_cube(cube, pitch_mask, T)
        t_valid, t_start, t_count = (torch.full((1,), v, dtype=torch.int32, device=d) for v in (T, 0, T))
        out = render_matrix(m[None], energy[None], e_valid[None], t_valid, t_start, t_count, x_map[None],
                            z_bounds[None], lut[None], spec)
        return out["rgba"][0], out["vmin"][0], out["vmax"][0]

    return forward, args


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _rank_main(target: tuple[str, str], rank: int, n: int, backend: str | None, address: str, env: dict,
               args: tuple, results) -> None:
    """A spawned rank: its environment first, then the port, the group, *target*, and the group's end."""
    os.environ.update(env)
    try:
        from configurable_spectrograms_torch.parallel.mesh import init_distributed, shutdown_distributed

        fn = getattr(importlib.import_module(target[0]), target[1])
        init_distributed(address, n, rank, backend=backend)
        try:
            out = fn(rank, *args)
        finally:
            shutdown_distributed()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, n: int, backend: str | None = None, args: tuple = (), env: dict | None = None,
                local_ranks: list[int] | None = None, timeout: float = 900.0) -> list:
    """Run ``fn(rank, *args)`` in *n* spawned ranks of one process group; their return values in rank order.

    Each rank is a fresh process (start method ``spawn``: a rank forked
    after CUDA started could not use it) with *env* added to this process's
    environment and ``LOCAL_RANK`` set to ``local_ranks[rank]`` (default:
    the rank); it joins the group through
    :func:`..parallel.mesh.init_distributed` at a ``127.0.0.1`` address
    with *backend* (default: NCCL on a card, Gloo on the CPU), and leaves
    it when *fn* returns.  *fn* must be a module-level function; its
    module is imported after the environment is set.  A rank that raises,
    dies or outlives *timeout* seconds fails the call, and every rank
    still running is stopped.
    """
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"127.0.0.1:{_free_port()}"
    target = (fn.__module__, fn.__qualname__)
    procs = []
    try:
        for rank in range(n):
            local = rank if local_ranks is None else local_ranks[rank]
            child_env = {**(env or {}), "LOCAL_RANK": str(local)}
            p = ctx.Process(target=_rank_main, args=(target, rank, n, backend, address, child_env, args, results),
                            name=f"rank{rank}")
            p.start()
            procs.append(p)
        out: list = [None] * n
        deadline = time.monotonic() + timeout
        for _ in range(n):
            while True:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                    break
                except queue_mod.Empty:
                    dead = [p.name for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"{', '.join(dead)} died without a result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"the ranks did not finish within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"{p.name} exited with {p.exitcode}")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()


def _dryrun_rank(rank: int, root: str) -> dict:
    """One rank of :func:`dryrun_multichip`: the collective extrema, then the batch driver on *root*'s archive."""
    import torch.distributed as dist

    from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_directory
    from configurable_spectrograms_torch.ops import extrema_ops
    from configurable_spectrograms_torch.parallel import make_mesh, sharded_extrema_stats
    from configurable_spectrograms_torch.render import dispatch
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    n_devices = dist.get_world_size()
    time_axis = 2 if n_devices % 2 == 0 else 1
    data_axis = n_devices // time_axis
    mesh = make_mesh(n_devices, axis_names=("data", "time"), axis_sizes=(data_axis, time_axis))

    rng = np.random.default_rng(1)
    N = data_axis * 2  # two files per data shard
    T, A, E = 16 * time_axis, 4, 8
    cubes = (rng.random((N, T, A, E)) * 50).astype(np.float32)
    t_valids = np.full((N,), T, np.int32)

    # Phase 1: the collective extrema (all_reduce over data x time), held to one process's stats.
    counts, hist = sharded_extrema_stats(cubes, t_valids, mesh)
    if counts.shape != (N, E) or extrema_ops.hist_percentile(hist, 95.0) <= 0:
        raise AssertionError(f"extrema: counts {counts.shape}, hist sum {int(hist.sum())}")
    ref = extrema_ops.batched_file_stats(list(cubes))
    if not (np.array_equal(counts, np.stack([r["counts"] for r in ref]))
            and np.array_equal(hist, np.sum([r["hist"] for r in ref], axis=0))):
        raise AssertionError("sharded extrema stats differ from one process's batched_file_stats")

    # Phase 2: the production batch driver over this rank's share of the orbits.
    results = FAST_plot_spectrograms_directory(
        directory_path=os.path.join(root, "data"),
        output_base=os.path.join(root, "out"),
        y_scale="log",
        z_scale="log",
        colormap="inferno",
        max_workers=2,
        orbit_timeout_seconds=600,
        instrument_timeout_seconds=600,
        progress_json_path=os.path.join(root, "progress.json"),
        extrema_json_path=os.path.join(root, "extrema.json"),
        max_processing_percentile=99.0,
        retry_timeouts=False,
        verbose=False,
    )
    if not results or any(r.get("status") != "ok" for r in results):
        raise AssertionError(f"rank {rank}: {results}")
    device = str(get_device())
    for name, record in (("render", dispatch.LAST_DISPATCH), ("extrema pre-pass", extrema_ops.LAST_DISPATCH)):
        if record["device"] != device:
            raise AssertionError(f"rank {rank}: the {name} last ran on {record['device']}, not its device {device}")
    return {"rank": rank, "device": device, "orbits": sorted({int(r["orbit"]) for r in results})}


def dryrun_multichip(n_devices: int, backend: str | None = None) -> list[dict]:
    """The real flagship batch path in *n_devices* ranks (tiny shapes); each rank's record.

    Phase 1 runs the collective extrema reduction over a ``('data',
    'time')`` mesh (data-parallel over files, sequence-parallel over the
    time axis) and holds it to one process's ``batched_file_stats``.  Phase
    2 runs the production driver,
    :func:`..fast.batch_directory.FAST_plot_spectrograms_directory`, on a
    synthetic two-orbit archive: the ranks split the orbits, and each
    rank's extrema pre-pass and render must have run on its own device
    (``cuda:{rank}`` under NCCL, one card per rank).  *backend* as in
    :func:`spawn_ranks`; the device is the port's (``CST_TORCH_DEVICE``).
    """
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    with tempfile.TemporaryDirectory(prefix="cst_dryrun_") as root:
        orbits = [4100, 4101]
        synth_fast_archive(os.path.join(root, "data"), orbits, n_time=64, n_angle=8, n_energy=16,
                           cusp_csv_path=os.path.join(root, "cusp.tsv"))
        # Small smoke figures, and the synthetic cusp index rather than the repository's real one.
        env = {"CST_FAST_SAVE_DPI": os.environ.get("CST_FAST_SAVE_DPI", "40"),
               "CST_CUSP_CSV": os.path.join(root, "cusp.tsv")}
        records = spawn_ranks(_dryrun_rank, n_devices, backend, args=(root,), env=env)
        done = sorted(o for r in records for o in r["orbits"])
        if done != orbits:
            raise AssertionError(f"the ranks rendered orbits {done}, not {orbits}")
        for r in records:
            if r["device"].startswith("cuda") and r["device"] != f"cuda:{r['rank']}":
                raise AssertionError(f"rank {r['rank']} computed on {r['device']}")
        return records


if __name__ == "__main__":
    import torch

    fn, args = entry()
    print("forward:", tuple(fn(*args)[0].shape))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 2
    dryrun_multichip(n)
    print("dryrun_multichip ok on", n, "ranks")
