"""The port's device-resident cube cache, staging pool, PendingRender and upload telemetry, on the CPU.

Device = CPU tensors: the cache, its budget, owner-death eviction, the
telemetry and the enqueue/wait split run exactly as on a card; only the
pinned staging and the copy stream are CUDA-only, and the staging pool's
reuse rule is held here with stand-in events.
"""

import gc
import sys
import threading

import numpy as np
import pytest
import torch

from configurable_spectrograms_torch.render import device_cache, dispatch
from configurable_spectrograms_torch.render.panel import PanelData
from configurable_spectrograms_torch.render.tile import TimeWindow

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    device_cache.clear_cube_caches()
    yield
    device_cache.clear_cube_caches()


CPU = torch.device("cpu")


def test_budget_is_a_quarter_of_the_device_memory():
    import os

    assert device_cache.device_cube_budget(CPU) == os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4
    assert device_cache.cube_cache(CPU)._byte_budget() == device_cache.device_cube_budget(CPU)
    assert device_cache.cube_cache(CPU) is device_cache.cube_cache(torch.device("cpu"))


def _cube(seed, T=40, A=6, E=10):
    return (np.random.default_rng(seed).random((T, A, E)) * 100).astype(np.float32)


def _panels(cube, z=None):
    T, A, E = cube.shape
    return [
        PanelData(cube=cube, pitch_mask=mask, energy=np.geomspace(4000, 10, E).astype(np.float32),
                  times=np.arange(T, dtype=np.float64), window=TimeWindow(0, T, (0.0, T - 1.0), (0.0, T - 1.0)),
                  y_min=0.0, y_max=4000.0, z_min=None if z is None else z[0], z_max=None if z is None else z[1],
                  y_scale="linear", z_scale="log", colormap="viridis", x_is_unix=True, z_label="Counts")
        for mask in (np.ones(A, bool), np.arange(A) < A // 2)
    ]


def _delta(before: dict) -> dict:
    after = device_cache.upload_telemetry()
    return {k: after[k] - before[k] for k in after}


def _padded_bytes(cube) -> int:
    """Bytes of the cube's resident padded copy (uploads ship only ``cube.nbytes``: the padding is filled on the device)."""
    T, A, E = cube.shape
    return dispatch._bucket(T, 256, 64) * dispatch._bucket(A, 8, 8) * dispatch._bucket(E, 8, 8) * 4


def test_second_render_of_a_cube_ships_nothing():
    cube = _cube(0)
    panels = _panels(cube) + _panels(cube, z=(2.0, 900.0))  # a raw and a given bucket of one cube
    t0 = device_cache.upload_telemetry()
    first = dispatch.device_render_panels(panels, 16, 24)
    d1 = _delta(t0)
    assert d1["upload_bytes"] == cube.nbytes and d1["cube_misses"] == 1 and d1["cube_hits"] == 1
    assert d1["dispatches"] == 2 and d1["lanes"] == 4
    t1 = device_cache.upload_telemetry()
    second = dispatch.device_render_panels(panels, 16, 24)
    d2 = _delta(t1)
    assert d2["upload_bytes"] == 0 and d2["cube_misses"] == 0 and d2["cube_hits"] == 2
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a["rgba"], b["rgba"])


def test_owner_death_evicts():
    cube = _cube(1)
    dispatch.device_render_panels(_panels(cube), 16, 24)
    assert len(device_cache.cube_cache(CPU)) == 1
    del cube
    gc.collect()
    assert len(device_cache.cube_cache(CPU)) == 0


def test_budget_evicts_fifo(monkeypatch):
    from configurable_spectrograms_torch.utils.resident_cache import ResidentCache

    cubes = [_cube(s) for s in range(3)]
    monkeypatch.setitem(device_cache._CUBE_CACHES, str(CPU), ResidentCache(max_bytes=2 * _padded_bytes(cubes[0])))
    for c in cubes:
        dispatch.device_render_panels(_panels(c), 16, 24)
    keys = device_cache.cube_cache(CPU).keys()
    assert [k[0] for k in keys] == [id(cubes[1]), id(cubes[2])]
    t0 = device_cache.upload_telemetry()
    dispatch.device_render_panels(_panels(cubes[0]), 16, 24)  # evicted first: uploads again
    assert _delta(t0)["cube_misses"] == 1


def test_cache_off_gives_identical_results_and_uploads_every_time(monkeypatch):
    cube = _cube(2)
    panels = _panels(cube) + _panels(cube, z=(2.0, 900.0))
    cached = dispatch.device_render_panels(panels, 16, 24)
    monkeypatch.setenv("CST_DEVICE_CUBE_CACHE", "0")
    for _ in range(2):
        t0 = device_cache.upload_telemetry()
        off = dispatch.device_render_panels(panels, 16, 24)
        d = _delta(t0)
        assert d["upload_bytes"] == 2 * cube.nbytes and d["cube_hits"] == d["cube_misses"] == 0
        for a, b in zip(cached, off):
            np.testing.assert_array_equal(a["rgba"], b["rgba"])
            assert a["vmin"] == b["vmin"] and a["vmax"] == b["vmax"]


def test_stack_cubes_pads_with_nan_and_views_one_resident_cube():
    a, b = _cube(3, T=30, A=5, E=9), _cube(4, T=30, A=5, E=9)
    dev = CPU
    one = device_cache.stack_cubes([a], 64, 8, 16, dev)
    assert one.shape == (1, 64, 8, 16)
    assert one.data_ptr() == device_cache.cube_cache(CPU).values()[0].tensor.data_ptr()  # a view, no copy
    two = device_cache.stack_cubes([a, b], 64, 8, 16, dev)
    for u, c in enumerate((a, b)):
        np.testing.assert_array_equal(two[u, :30, :5, :9].numpy(), c)
        assert torch.isnan(two[u, 30:]).all() and torch.isnan(two[u, :, 5:]).all() and torch.isnan(two[u, ..., 9:]).all()
    uncached = device_cache.stack_cubes([a, b], 64, 8, 16, dev, cached=False)
    assert torch.equal(uncached.nan_to_num(-1.0), two.nan_to_num(-1.0))


class _Event:
    """A stand-in for a CUDA event: complete once ``done`` is set."""

    def __init__(self):
        self.done = False
        self.waited = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


def test_staging_buffer_is_reused_only_after_its_copy_event():
    made = []
    pool = device_cache.StagingPool(keep=2, alloc=lambda n: made.append(torch.empty(n, dtype=torch.uint8)) or made[-1])
    a = pool.take(100)
    ev_a = _Event()
    pool.give(a, ev_a)
    b = pool.take(100)  # a's copy is in flight and fewer than 2 buffers exist: a new one
    assert b is not a and len(made) == 2 and ev_a.waited == 0
    ev_b = _Event()
    pool.give(b, ev_b)
    c = pool.take(100)  # both in flight, 2 allocated: wait on a free one's event before reuse
    assert (c is a or c is b) and len(made) == 2 and (ev_a.waited + ev_b.waited) == 1
    pool.give(c, None)
    ev_b.done = ev_a.done = True
    d = pool.take(100)  # a completed buffer is taken with no wait
    assert (d is a or d is b) and ev_a.waited + ev_b.waited == 1
    big = pool.take(1000)  # no free buffer is large enough
    assert big.numel() == 1000 and len(made) == 3
    pool.give(big, None)
    pool.give(d, None)
    assert len(pool._free) == 2  # the oldest beyond `keep` is dropped


def test_enqueue_then_wait_equals_render_and_holds_its_tensors():
    from configurable_spectrograms_torch.render.drain import PendingRender

    cube = _cube(5, T=300)  # Tp > the pixel width: the bucket gathers rows on the device
    panels = _panels(cube) + _panels(cube, z=(2.0, 900.0))
    pending = dispatch.enqueue_render_panels(panels, 16, 24)
    assert isinstance(pending, PendingRender) and pending.has_device_work()
    assert all(b.refs and b.refs[0].shape[0] == 1 for b in pending.buckets)
    got = pending.wait()
    assert not pending.buckets  # the buckets and their tensors are released after the wait
    for a, b in zip(got, dispatch.device_render_panels(panels, 16, 24)):
        np.testing.assert_array_equal(a["rgba"], b["rgba"])


def test_host_backend_enqueues_no_device_work(monkeypatch):
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    pending = dispatch.enqueue_render_panels(_panels(_cube(6)), 16, 24)
    assert not pending.has_device_work() and all(r is not None for r in pending.wait())
    assert not dispatch.enqueue_render_panels([], 16, 24).has_device_work()


def test_telemetry_counts_exactly_under_threads():
    """8 threads (more than this box's cores under a tiny switch interval) count without losing an add."""
    before = device_cache.upload_telemetry()
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(5000):
                device_cache.count(upload_bytes=3, lanes=1)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    d = _delta(before)
    assert d["upload_bytes"] == 8 * 5000 * 3 and d["lanes"] == 8 * 5000


def test_renders_from_4_threads_count_every_upload(monkeypatch):
    monkeypatch.setenv("CST_DEVICE_CUBE_CACHE", "0")
    monkeypatch.setenv("CST_RENDER_COALESCE", "0")
    cubes = [_cube(10 + k) for k in range(8)]
    before = device_cache.upload_telemetry()
    threads = [threading.Thread(target=dispatch.device_render_panels, args=(_panels(c), 16, 24)) for c in cubes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    d = _delta(before)
    assert d["upload_bytes"] == sum(c.nbytes for c in cubes) and d["dispatches"] == 8 and d["lanes"] == 16
