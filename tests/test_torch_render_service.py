"""The port's render coalescer (``render/service.py``) and the figure path through it, on the CPU.

Coalesced results equal direct ones (and the JAX package's on the host
backends), concurrent requests pool, geometries stay apart, the empty
request, a drainer failure fails every pooled future, and a batch's
readback overlaps the next batch.  An enqueue that fails fails only its
geometry's requests; a dispatcher killed by a ``BaseException`` fails its
whole batch and the next render starts a fresh one; at most
``MAX_INFLIGHT`` batches hold device work at once.  A figure's panels
render on the dispatcher and its composite on the caller, and figures
saved from more threads than cores equal the same figures saved serially,
byte for byte.
"""

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from configurable_spectrograms_torch.render import dispatch, drain, service
from configurable_spectrograms_torch.render.panel import PanelData
from configurable_spectrograms_torch.render.tile import TimeWindow

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")


def _panel(rng, T=40, A=6, E=10, cmap="viridis", module=None):
    cls = PanelData if module is None else module.PanelData
    window_cls = TimeWindow if module is None else module.TimeWindow
    cube = (rng.random((T, A, E)) * 100).astype(np.float32)
    return cls(cube=cube, pitch_mask=np.ones(A, bool), energy=np.geomspace(4000, 10, E).astype(np.float32),
               times=np.arange(T, dtype=np.float64),
               window=window_cls(0, T, (0.0, float(T - 1)), (0.0, float(T - 1))), y_min=0.0, y_max=4000.0,
               z_min=None, z_max=None, y_scale="linear", z_scale="log", colormap=cmap, x_is_unix=True,
               z_label="Counts")


def _same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["rgba"], y["rgba"])
        assert float(x["vmin"]) == float(y["vmin"]) and float(x["vmax"]) == float(y["vmax"])


@pytest.mark.parametrize("backend", ["device", "host"])
def test_coalesced_matches_direct(backend, monkeypatch):
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    panels = [_panel(np.random.default_rng(s)) for s in range(3)]
    _same(service.coalesced_render(panels, 24, 32), dispatch.device_render_panels(panels, 24, 32))


def test_coalesced_matches_the_jax_package_on_the_host_backends(monkeypatch):
    from types import SimpleNamespace

    from configurable_spectrograms_tpu.render import figure as jfigure
    from configurable_spectrograms_tpu.render import service as jservice
    from configurable_spectrograms_tpu.render import tile as jtile

    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    monkeypatch.setitem(jfigure._BACKEND, "mode", "host")
    jmod = SimpleNamespace(PanelData=jfigure.PanelData, TimeWindow=jtile.TimeWindow)
    mine = [_panel(np.random.default_rng(s)) for s in range(4)]
    theirs = [_panel(np.random.default_rng(s), module=jmod) for s in range(4)]
    _same(service.coalesced_render(mine, 24, 32), jservice.coalesced_render(theirs, 24, 32))


def test_concurrent_requests_pool(monkeypatch):
    """Requests arriving while a batch is being enqueued are pooled into the next one."""
    requests = [[_panel(np.random.default_rng(10 + k)) for _ in range(2)] for k in range(6)]
    expected = [dispatch.device_render_panels(req, 16, 24) for req in requests]
    real = dispatch.enqueue_render_panels
    sizes = []

    def slow_first(panels, th, tw):
        sizes.append(len(panels))
        if len(sizes) == 1:
            time.sleep(0.3)  # the others queue up behind the first batch
        return real(panels, th, tw)

    monkeypatch.setattr(dispatch, "enqueue_render_panels", slow_first)
    fresh = service.RenderCoalescer()
    with ThreadPoolExecutor(max_workers=6) as pool:
        first = pool.submit(fresh.render, requests[0], 16, 24)
        time.sleep(0.05)
        rest = [pool.submit(fresh.render, req, 16, 24) for req in requests[1:]]
        got = [first.result(timeout=60)] + [f.result(timeout=60) for f in rest]
    for exp, g in zip(expected, got):
        _same(exp, g)
    assert sum(sizes) == 12 and len(sizes) < 6, sizes  # at least two requests shared a batch


def test_mixed_geometries_concurrently():
    rng = np.random.default_rng(1)
    reqs = [([_panel(rng)], 16, 24), ([_panel(rng)], 32, 40), ([_panel(rng)], 16, 24)]
    with ThreadPoolExecutor(max_workers=3) as pool:
        got = list(pool.map(lambda r: service.coalesced_render(*r), reqs))
    for (panels, th, tw), res in zip(reqs, got):
        assert res[0]["rgba"].shape == (th, tw, 4)
        _same(res, dispatch.device_render_panels(panels, th, tw))


def test_empty_request():
    assert service.coalesced_render([], 8, 8) == []


class _Boom(BaseException):
    pass


@pytest.mark.parametrize("error", [RuntimeError, _Boom])
def test_drainer_failure_fails_every_future(error, monkeypatch):
    class ExplodingPending:
        def has_device_work(self):
            return True

        def wait(self):
            raise error("drain exploded")

    monkeypatch.setattr(dispatch, "enqueue_render_panels", lambda panels, th, tw: ExplodingPending())
    fresh = service.RenderCoalescer()
    rng = np.random.default_rng(2)
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(fresh.render, [_panel(rng)], 16, 24) for _ in range(2)]
        for f in futures:
            with pytest.raises(error, match="drain exploded"):
                f.result(timeout=30)


def test_batches_overlap(monkeypatch):
    """While batch A drains on a side thread, the dispatcher enqueues batch B."""
    real_wait = drain.PendingRender.wait

    def slow_wait(self):
        time.sleep(0.7)
        return real_wait(self)

    fresh = service.RenderCoalescer()
    rng = np.random.default_rng(3)
    fresh.render([_panel(rng)], 16, 24)  # warm up
    monkeypatch.setattr(drain.PendingRender, "wait", slow_wait)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        fa = pool.submit(fresh.render, [_panel(rng)], 16, 24)
        time.sleep(0.1)  # A is in flight before B arrives
        fb = pool.submit(fresh.render, [_panel(rng)], 16, 24)
        ra, rb = fa.result(timeout=30), fb.result(timeout=30)
    elapsed = time.perf_counter() - t0
    assert all("rgba" in r for r in ra + rb)
    assert elapsed < 1.35, f"two 0.7 s batches took {elapsed:.2f} s -- dispatcher serialized?"


def _hold_the_dispatcher(monkeypatch, fault=None):
    """Make the first enqueue block until *release* is set; later enqueues call *fault* first.

    Returns ``(entered, release, calls)``: *entered* is set once the first enqueue blocks, and *calls*
    records ``(tile_h, tile_w, thread)`` of every enqueue.
    """
    real = dispatch.enqueue_render_panels
    entered, release = threading.Event(), threading.Event()
    calls = []

    def enqueue(panels, th, tw):
        calls.append((th, tw, threading.current_thread()))
        if len(calls) == 1:
            entered.set()
            assert release.wait(30)
        elif fault is not None:
            fault(th, tw)
        return real(panels, th, tw)

    monkeypatch.setattr(dispatch, "enqueue_render_panels", enqueue)
    return entered, release, calls


def _wait_queued(coalescer, n: int) -> None:
    """Block until *n* requests wait in *coalescer*'s queue, to be drained at the dispatcher's next wake."""
    deadline = time.monotonic() + 30
    while True:
        with coalescer._lock:
            if len(coalescer._queue) == n:
                return
        assert time.monotonic() < deadline, "the requests never queued"
        time.sleep(0.01)


def _submit(fn, *args) -> Future:
    """``fn(*args)`` on a daemon thread: a render the coalescer never answers fails its test, not the run."""
    fut = Future()

    def run():
        try:
            fut.set_result(fn(*args))
        except BaseException as exc:  # noqa: BLE001 - read back through the future
            fut.set_exception(exc)

    threading.Thread(target=run, daemon=True).start()
    return fut


def test_enqueue_failure_fails_only_its_geometry(monkeypatch):
    failing = {(32, 40)}

    def fault(th, tw):
        if (th, tw) in failing:
            raise RuntimeError("enqueue failed")

    rng = np.random.default_rng(6)
    good, bad, later = [_panel(rng)], [_panel(rng)], [_panel(rng)]
    expected = {"good": dispatch.device_render_panels(good, 16, 24),
                "later": dispatch.device_render_panels(later, 32, 40)}
    fresh = service.RenderCoalescer()
    entered, release, calls = _hold_the_dispatcher(monkeypatch, fault)
    first = _submit(fresh.render, [_panel(rng)], 16, 24)
    assert entered.wait(30)
    f_good = _submit(fresh.render, good, 16, 24)
    f_bad = _submit(fresh.render, bad, 32, 40)
    _wait_queued(fresh, 2)
    release.set()
    assert "rgba" in first.result(timeout=60)[0]
    _same(f_good.result(timeout=60), expected["good"])
    with pytest.raises(RuntimeError, match="enqueue failed"):
        f_bad.result(timeout=60)
    assert sorted((th, tw) for th, tw, _ in calls[1:]) == [(16, 24), (32, 40)]  # one wake, both geometries
    failing.clear()
    # The next request is served, the failed geometry's too.
    _same(_submit(fresh.render, later, 32, 40).result(timeout=60), expected["later"])


def test_a_dying_dispatcher_fails_its_batch_and_the_next_render_restarts_it(monkeypatch):
    armed = [True]

    def fault(th, tw):
        if armed[0]:
            armed[0] = False
            raise _Boom("dispatcher killed")

    rng = np.random.default_rng(7)
    panels = [_panel(rng)]
    expected = dispatch.device_render_panels(panels, 16, 24)
    uncaught = []
    monkeypatch.setattr(threading, "excepthook", lambda args: uncaught.append(args.exc_type))
    fresh = service.RenderCoalescer()
    entered, release, calls = _hold_the_dispatcher(monkeypatch, fault)
    first = _submit(fresh.render, [_panel(rng)], 16, 24)
    assert entered.wait(30)
    drained = [_submit(fresh.render, [_panel(rng)], th, tw) for th, tw in ((16, 24), (32, 40), (16, 24))]
    _wait_queued(fresh, 3)
    release.set()
    assert "rgba" in first.result(timeout=60)[0]
    for f in drained:
        with pytest.raises(_Boom, match="dispatcher killed"):
            f.result(timeout=60)
    dead = calls[0][2]
    dead.join(30)
    assert not dead.is_alive() and uncaught == [_Boom]  # the dispatcher re-raised and exited
    _same(_submit(fresh.render, panels, 16, 24).result(timeout=60), expected)
    assert calls[-1][2] is not dead and calls[-1][2].name == "render-coalescer"


def test_at_most_max_inflight_batches_hold_device_work(monkeypatch):
    release = threading.Event()
    enqueued = []

    class Held:
        def __init__(self, panels):
            self.panels = panels

        def has_device_work(self):
            return True

        def wait(self):
            assert release.wait(30)
            return [{"panel": p} for p in self.panels]

    def enqueue(panels, th, tw):
        enqueued.append((th, tw))
        return Held(panels)

    monkeypatch.setattr(dispatch, "enqueue_render_panels", enqueue)
    fresh = service.RenderCoalescer()
    n = service.MAX_INFLIGHT + 2
    futures = [_submit(fresh.render, [k], 8, 8 + k) for k in range(n)]  # a geometry each: n batches
    deadline = time.monotonic() + 30
    while len(enqueued) < service.MAX_INFLIGHT and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)  # room for an enqueue past the bound
    held = len(enqueued)
    release.set()
    got = [f.result(timeout=60) for f in futures]
    assert held == service.MAX_INFLIGHT, enqueued
    assert got == [[{"panel": k}] for k in range(n)] and len(enqueued) == n


def _figure(seed: int, title: str):
    from configurable_spectrograms_torch.render.figure import SpectroFigure

    rng = np.random.default_rng(seed)
    fig = SpectroFigure(figsize=(3.0, 2.0), dpi=40)
    for k in (1, 2):
        ax = fig.add_subplot(1, 2, k)
        ax.panel = _panel(rng, cmap=("viridis", "inferno")[k - 1])
        ax.set_title(f"{title} {k}")
    fig.suptitle(title)
    return fig


@pytest.mark.parametrize("backend", ["device", "host"])
def test_savefig_from_more_threads_than_cores_matches_serial(backend, tmp_path, monkeypatch):
    """The oversubscribed case: every worker composites and encodes on its own thread at once."""
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    n = max(8, 2 * len(os.sched_getaffinity(0)))
    (tmp_path / "serial").mkdir()
    (tmp_path / "threads").mkdir()
    for k in range(n):
        _figure(k, f"figure {k}").savefig(str(tmp_path / "serial" / f"{k}.png"))
    start = threading.Barrier(n)
    errors = []

    def work(k):
        try:
            fig = _figure(k, f"figure {k}")
            start.wait(30)
            fig.savefig(str(tmp_path / "threads" / f"{k}.png"))
        except BaseException as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert not errors, errors
    for d in ("serial", "threads"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == sorted(f"{k}.png" for k in range(n)), d
    serial = [(tmp_path / "serial" / f"{k}.png").read_bytes() for k in range(n)]
    assert len(set(serial)) == n  # the figures are distinct
    assert [(tmp_path / "threads" / f"{k}.png").read_bytes() for k in range(n)] == serial


def test_render_figures_renders_on_the_dispatcher_and_composites_on_the_caller(monkeypatch):
    from configurable_spectrograms_torch.render.figure import render_figures
    from configurable_spectrograms_torch.utils import timing

    real = dispatch.enqueue_render_panels
    enqueue_threads = []

    def recording(panels, th, tw):
        enqueue_threads.append(threading.current_thread().name)
        return real(panels, th, tw)

    monkeypatch.setattr(dispatch, "enqueue_render_panels", recording)
    monkeypatch.setattr(service, "_COALESCER", service.RenderCoalescer())
    timer = timing.StageTimer("figure")
    monkeypatch.setattr(timing, "ACTIVE", timer)
    seen = {}

    def caller():
        seen["ident"] = threading.get_ident()
        seen["images"] = render_figures([_figure(8, "a"), _figure(9, "b")])

    t = threading.Thread(target=caller)
    t.start()
    t.join(60)
    assert not t.is_alive()
    monkeypatch.setattr(timing, "ACTIVE", None)
    assert [im.size for im in seen["images"]] == [(120, 80)] * 2
    assert enqueue_threads and set(enqueue_threads) == {"render-coalescer"}
    composites = [i for i in timer.intervals if i[0] == "composite"]
    assert len(composites) == 2 and {i[3] for i in composites} == {seen["ident"]}
