"""The port's render coalescer (``render/service.py``) and host-compute gate (``utils/compute_gate.py``), on the CPU.

Coalescer: coalesced results equal direct ones (and the JAX package's on
the host backends), concurrent requests pool, geometries stay apart, the
empty request, a drainer failure fails every pooled future, and a batch's
readback overlaps the next batch.  Gate: it bounds concurrency, nests
under one slot, ``gate_released`` admits a sibling and restores the
thread's state after an exception, an interrupted re-acquire mints no
phantom slot, and ``render_figures`` yields its slot only when the render
really blocks (coalescing on) -- the two faults of the JAX module.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from configurable_spectrograms_torch.render import dispatch, drain, service
from configurable_spectrograms_torch.render.panel import PanelData
from configurable_spectrograms_torch.render.tile import TimeWindow
from configurable_spectrograms_torch.utils import compute_gate

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


def test_coalescing_off_renders_inline(monkeypatch):
    monkeypatch.setenv("CST_RENDER_COALESCE", "0")
    threads = []
    real = dispatch.device_render_panels

    def recording(panels, th, tw):
        threads.append(threading.get_ident())
        return real(panels, th, tw)

    monkeypatch.setattr(dispatch, "device_render_panels", recording)
    res = service.RenderCoalescer().render([_panel(np.random.default_rng(4))], 16, 24)
    assert threads == [threading.get_ident()] and "rgba" in res[0]


# ---------------------------------------------------------------------------
# the host-compute gate
# ---------------------------------------------------------------------------


def _join(threads, timeout=20.0):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "a gated thread deadlocked"


def test_gate_bounds_concurrency(monkeypatch):
    monkeypatch.setenv("CST_HOST_COMPUTE_GATE", "2")
    live = {"n": 0, "max": 0}
    lock = threading.Lock()

    def work():
        with compute_gate.host_compute_gate():
            with lock:
                live["n"] += 1
                live["max"] = max(live["max"], live["n"])
            time.sleep(0.05)
            with lock:
                live["n"] -= 1

    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    _join(threads)
    assert live["max"] == 2, live
    monkeypatch.setenv("CST_HOST_COMPUTE_GATE", "0")
    with compute_gate.host_compute_gate():
        assert not compute_gate.holds_slot()  # disabled: no semaphore interaction


def test_nested_gates_under_one_slot_do_not_deadlock(monkeypatch):
    monkeypatch.setenv("CST_HOST_COMPUTE_GATE", "1")
    depths = []

    @compute_gate.gated
    def inner():
        depths.append(compute_gate._TLS.depth)

    def work():
        with compute_gate.host_compute_gate():
            with compute_gate.host_compute_gate():
                inner()
            depths.append(compute_gate._TLS.depth)
        depths.append(compute_gate._TLS.depth)

    t = threading.Thread(target=work)
    t.start()
    _join([t])
    assert depths == [3, 1, 0]
    assert compute_gate._gate(1)._value == 1  # the slot is back


def test_gate_released_admits_a_sibling_and_restores_after_an_exception(monkeypatch):
    monkeypatch.setenv("CST_HOST_COMPUTE_GATE", "1")
    sibling_ran = threading.Event()
    state = {}

    def sibling():
        with compute_gate.host_compute_gate():
            sibling_ran.set()

    def work():
        with compute_gate.host_compute_gate():
            with compute_gate.host_compute_gate():
                try:
                    with compute_gate.gate_released():
                        assert not compute_gate.holds_slot()
                        s = threading.Thread(target=sibling)
                        s.start()
                        state["admitted"] = sibling_ran.wait(10)
                        s.join(10)
                        raise ValueError("inside the released window")
                except ValueError:
                    pass
                state["after"] = (compute_gate._TLS.depth, compute_gate.holds_slot())
        state["end"] = (compute_gate._TLS.depth, compute_gate.holds_slot())

    t = threading.Thread(target=work)
    t.start()
    _join([t])
    assert state == {"admitted": True, "after": (2, True), "end": (0, False)}
    assert compute_gate._gate(1)._value == 1


def test_interrupted_reacquire_mints_no_phantom_slot(monkeypatch):
    """ADVICE r5: a re-acquire interrupted in gate_released must not be released again by the outer gate."""

    class Interruptible(threading.BoundedSemaphore):
        armed = False

        def acquire(self, *a, **k):
            if self.armed:
                self.armed = False
                raise KeyboardInterrupt
            return super().acquire(*a, **k)

    monkeypatch.setenv("CST_HOST_COMPUTE_GATE", "2")
    gate = Interruptible(2)
    monkeypatch.setattr(compute_gate, "_GATE", gate)
    monkeypatch.setattr(compute_gate, "_GATE_SLOTS", 2)
    other_in, other_out = threading.Event(), threading.Event()

    def other():  # holds the second slot throughout
        with compute_gate.host_compute_gate():
            other_in.set()
            other_out.wait(10)

    o = threading.Thread(target=other)
    o.start()
    assert other_in.wait(10)
    outcome = {}

    def work():
        try:
            with compute_gate.host_compute_gate():
                with compute_gate.gate_released():
                    gate.armed = True
        except KeyboardInterrupt:
            outcome["interrupted"] = True
        outcome["value_after"] = gate._value

    t = threading.Thread(target=work)
    t.start()
    _join([t])
    other_out.set()
    _join([o])
    # While `other` held one of the 2 slots, one was free: the interrupted thread holds none and gave
    # none back twice.  (The JAX module's outer exit released again: 2 free while `other` held one.)
    assert outcome == {"interrupted": True, "value_after": 1}
    assert gate._value == 2


@pytest.mark.parametrize("coalesce", ["1", "0"])
def test_render_figures_yields_its_slot_only_when_the_render_blocks(coalesce, monkeypatch):
    """Coalescing on: a sibling may compute while this render waits.  Off: the inline render keeps the slot."""
    from configurable_spectrograms_torch.render.figure import SpectroFigure, render_figures

    monkeypatch.setenv("CST_HOST_COMPUTE_GATE", "1")
    monkeypatch.setenv("CST_RENDER_COALESCE", coalesce)
    seen = {}
    real = dispatch.enqueue_render_panels

    def probe(panels, th, tw):
        seen["inline_holds_slot"] = compute_gate.holds_slot()
        got = threading.Event()

        def sibling():
            with compute_gate.host_compute_gate():
                got.set()

        s = threading.Thread(target=sibling, daemon=True)
        s.start()
        seen["sibling_admitted"] = got.wait(1.0)
        pending = real(panels, th, tw)
        if not seen["sibling_admitted"]:
            pending._sibling = s  # it runs once this render gives its slot back
        return pending

    monkeypatch.setattr(dispatch, "enqueue_render_panels", probe)
    monkeypatch.setattr(service, "_COALESCER", service.RenderCoalescer())  # its dispatcher binds the probe
    fig = SpectroFigure(figsize=(3.0, 2.0), dpi=40)
    fig.add_subplot(1, 1, 1).panel = _panel(np.random.default_rng(5))
    t = threading.Thread(target=lambda: seen.setdefault("image", render_figures([fig])[0]))
    t.start()
    _join([t], timeout=60)
    assert seen["image"].size == (120, 80)
    if coalesce == "1":
        assert seen["sibling_admitted"] and not seen["inline_holds_slot"]  # the dispatcher thread holds none
    else:
        assert seen["inline_holds_slot"] and not seen["sibling_admitted"]
