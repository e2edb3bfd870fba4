"""The port's stages (``utils.timing``): where they are recorded, their intervals, and the profiler's trace.

The flagship driver runs over one tiny synthetic archive (2 orbits, 2
instruments, 2 workers, the exact extrema pre-pass, the device back end on
CPU tensors) and the audio CLI renders one short recording.  With a stage
timer active every stage the port records shows; its intervals lie inside
the call, on the ``perf_counter`` clock, and a thread's stages do not
overlap, except a tracker regather's decode inside ``prepass_tracker`` and
the int16 samples' upload inside ``wav_load``.
With no timer active nothing reads the clock.  ``CST_PROFILE_DIR`` traces
the whole driver call, pre-pass and worker threads, with the stages in it.
"""

import json
import threading
import time
import types
import wave

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ORBITS = [4100, 4101]
FLAGSHIP_STAGES = {"cdf_decode", "prepass_stats", "prepass_host_collapse", "prepass_tracker",
                   "render_queue_wait", "device_dispatch", "render_wait", "composite", "png_encode"}
AUDIO_STAGES = {"wav_load", "pcm_upload", "render_queue_wait", "device_dispatch", "render_wait", "composite",
                "png_encode"}
NESTED = {("prepass_tracker", "cdf_decode"), ("wav_load", "pcm_upload")}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("torch_stages")
    synth_fast_archive(str(root / "data"), ORBITS, instruments=("ees", "ies"), n_time=64, n_angle=8,
                       n_energy=16, cusp_csv_path=str(root / "cusp.tsv"), seed=7)
    rate = 8000
    t = np.arange(rate // 2) / rate
    pcm = (0.5 * np.sin(2 * np.pi * 440.0 * t) * 32767).astype("<i2")
    with wave.open(str(root / "tone.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return {"data": str(root / "data"), "cusp": str(root / "cusp.tsv"), "wav": str(root / "tone.wav")}


@pytest.fixture
def port(archive, monkeypatch):
    """The port on the CPU, device back end, exact pre-pass; resets the stage timer after."""
    from configurable_spectrograms_torch.data import cdf_utils
    from configurable_spectrograms_torch.utils import timing

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    monkeypatch.setenv("CST_CUSP_CSV", archive["cusp"])
    for name in ("CST_EXTREMA_EXACT", "CST_PROFILE_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(cdf_utils, "filtered_orbits_cache", {})
    cdf_utils.clear_dataset_cache()
    yield timing
    timing.ACTIVE = None
    cdf_utils.clear_dataset_cache()


def _flagship(archive, out) -> list[dict]:
    from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_multi

    out.mkdir(parents=True, exist_ok=True)
    results = FAST_plot_spectrograms_multi(
        archive["data"], combos=(("linear", "log", "cividis"), ("log", "log", "inferno")),
        output_base=str(out / "plots"), progress_json_path=str(out / "progress.json"),
        extrema_json_path=str(out / "extrema.json"), max_workers=2, max_processing_percentile=99,
        retry_timeouts=False, use_tqdm=False, orbit_timeout_seconds=600, instrument_timeout_seconds=300)
    assert [r["status"] for r in results] == ["ok"] * 8  # 2 combos x 2 orbits x raw and given extrema
    return results


def _audio(archive, out) -> None:
    from configurable_spectrograms_torch.cli.audio import render_audio_spectrogram

    assert render_audio_spectrogram(archive["wav"], str(out / "tone.png"))


def _assert_threads_do_not_overlap(intervals: list[tuple]) -> None:
    """Per thread, each stage ends before the next starts, but for the pairs of :data:`NESTED` (outer, inner)."""
    by_thread: dict[int, list[tuple]] = {}
    for name, t0, t1, ident in intervals:
        if ident is not None:
            by_thread.setdefault(ident, []).append((t0, t1, name))
    for spans in by_thread.values():
        spans.sort()
        outer = None
        for t0, t1, name in spans:
            if outer is not None and t0 < outer[1]:
                assert (outer[2], name) in NESTED and t1 <= outer[1], (outer, name)
                continue
            outer = (t0, t1, name)


@pytest.mark.parametrize("call, stages", [(_flagship, FLAGSHIP_STAGES), (_audio, AUDIO_STAGES)],
                         ids=["flagship", "audio"])
def test_active_timer_records_every_stage_inside_the_call(call, stages, archive, port, tmp_path):
    timer = port.ACTIVE = port.StageTimer("test")
    t_before = time.perf_counter()
    call(archive, tmp_path)
    t_after = time.perf_counter()
    port.ACTIVE = None
    assert stages <= {k for k, n in timer.counts.items() if n > 0}, sorted(timer.counts)
    assert sum(timer.counts.values()) == len(timer.intervals)
    for name, t0, t1, _ in timer.intervals:
        assert t_before <= t0 <= t1 <= t_after, name
    for stage in stages:
        dts = [t1 - t0 for name, t0, t1, _ in timer.intervals if name == stage]
        assert sum(dts) == pytest.approx(timer.totals[stage], rel=1e-9, abs=1e-12)
    _assert_threads_do_not_overlap(timer.intervals)
    waits = [i for i in timer.intervals if i[0] == "render_queue_wait"]
    assert waits and all(i[3] is None for i in waits)  # closed by the dispatcher, waited on a worker


def test_no_active_timer_records_nothing_and_reads_no_clock(archive, port, tmp_path, monkeypatch):
    from configurable_spectrograms_torch.render import service

    reads = []

    def perf_counter():
        reads.append(threading.get_ident())
        return time.perf_counter()

    clock = types.SimpleNamespace(perf_counter=perf_counter, time_ns=time.time_ns)
    monkeypatch.setattr(port, "time", clock)
    monkeypatch.setattr(service, "time", clock)
    keep = port.StageTimer._keep
    kept = []
    monkeypatch.setattr(port.StageTimer, "_keep", lambda self, *a: (kept.append(a), keep(self, *a)))
    assert port.ACTIVE is None
    _flagship(archive, tmp_path / "fast")
    _audio(archive, tmp_path)
    assert reads == [] and kept == []


def test_queue_waits_from_many_threads_lose_no_update(port, monkeypatch):
    from configurable_spectrograms_torch.render import dispatch
    from configurable_spectrograms_torch.render.service import RenderCoalescer

    class Done:
        def __init__(self, panels):
            self.panels = panels

        def has_device_work(self):
            return False

        def wait(self):
            time.sleep(0.001)
            return [{"panel": p} for p in self.panels]

    monkeypatch.setattr(dispatch, "enqueue_render_panels", lambda panels, h, w: Done(panels))
    coalescer = RenderCoalescer()
    timer = port.ACTIVE = port.StageTimer("threads")
    n_threads, n_calls = 6, 40
    got = []

    def worker(k):
        for j in range(n_calls):
            got.append(coalescer.render([(k, j)], 4, 4) == [{"panel": (k, j)}])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    port.ACTIVE = None
    n = n_threads * n_calls
    assert got == [True] * n
    assert timer.counts["render_queue_wait"] == timer.counts["render_wait"] == n
    assert len({i[3] for i in timer.intervals if i[0] == "render_wait"}) == n_threads
    assert sum(1 for i in timer.intervals if i[0] == "render_queue_wait") == n
    for name in ("render_queue_wait", "render_wait"):
        assert all(w >= 0 for w in [t1 - t0 for s, t0, t1, _ in timer.intervals if s == name])
    _assert_threads_do_not_overlap(timer.intervals)


def test_profile_dir_traces_the_prepass_and_the_workers_with_their_stages(archive, port, tmp_path, monkeypatch):
    monkeypatch.setenv("CST_PROFILE_DIR", str(tmp_path / "profile"))
    _flagship(archive, tmp_path / "fast")
    assert port.ACTIVE is None and not port._PROFILING
    (trace,) = (tmp_path / "profile").glob("trace-*.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    tids = {}
    for e in events:
        tids.setdefault(e["name"], set()).add(e["tid"])
    prepass = tids.get("prepass_stats", set()) | tids.get("prepass_tracker", set())
    assert prepass, sorted(tids)
    workers = tids.get("composite", set()) | tids.get("png_encode", set())
    assert workers and not workers & prepass, sorted(tids)  # rendered on the pool's threads
    assert {"cdf_decode", "render_wait", "device_dispatch"} <= set(tids)
