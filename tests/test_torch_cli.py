"""The port's entry points against the JAX package's, on the CPU.

The audio and single-CDF CLIs and ``generic_batch_plot`` must write the
same pixels as the JAX package's functions on the host backend; the exit
codes (0 saved, 1 nothing to plot, 2 usage, 130 interrupted) and the
resumable batch progress must behave as the JAX package's do.
"""

import functools
import json
import os
import subprocess
import sys
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _pixels(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _same_pixels(a, b) -> None:
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape, (pa.shape, pb.shape)
    assert not (pa != pb).any(axis=-1).any(), f"{(pa != pb).any(axis=-1).mean():.4%} of pixels differ"


def _run_main(monkeypatch, main, argv) -> int:
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    try:
        rc = main()
    except SystemExit as exc:
        rc = exc.code
    return 0 if rc is None else rc


@pytest.fixture
def host_backends(monkeypatch):
    """Both packages on their host backends (the golden-figure path)."""
    from configurable_spectrograms_tpu.render import figure as jfigure

    monkeypatch.setitem(jfigure._BACKEND, "mode", "host")
    monkeypatch.setenv("CST_RENDER_BACKEND", "host")
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory) -> str:
    rng = np.random.default_rng(4)
    rate = 8000
    t = np.arange(rate) / rate
    sig = 0.4 * np.sin(2 * np.pi * (150 + 1800 * t) * t) + 0.2 * np.sin(2 * np.pi * 2500 * t)
    sig = sig + 0.01 * rng.standard_normal(t.size)
    path = str(tmp_path_factory.mktemp("wav") / "chirp.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((sig * 32767).astype("<i2").tobytes())
    return path


@pytest.fixture(scope="module")
def cdf_archive(tmp_path_factory) -> dict:
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("cli_archive")
    return synth_fast_archive(str(root / "data"), [4300], n_time=80, n_angle=8, n_energy=16,
                              cusp_csv_path=str(root / "cusp.tsv"), seed=11)[4300]


@pytest.mark.parametrize("argv", [[], ["--n-mels", "32"], ["--n-mels", "16", "--y-scale", "log", "--colormap", "inferno"]])
def test_audio_cli_writes_the_jax_packages_pixels(argv, wav_file, tmp_path, host_backends, monkeypatch):
    import single_plot_audio_spectrogram as jcli

    from configurable_spectrograms_torch.cli import audio

    out = str(tmp_path / "port.png")
    rc = _run_main(monkeypatch, audio.main, ["--wav-file", wav_file, "--output", out,
                                             "--frame-length", "256", "--hop-length", "64", *argv])
    assert rc == 0
    ref = str(tmp_path / "jax.png")
    assert _run_main(monkeypatch, jcli.main, ["--wav-file", wav_file, "--output", ref,
                                              "--frame-length", "256", "--hop-length", "64", *argv]) == 0
    _same_pixels(out, ref)
    sig, rate = audio.load_wav(wav_file)
    jsig, jrate = jcli.load_wav(wav_file)
    assert rate == jrate and np.array_equal(sig, jsig)


@pytest.mark.parametrize("backend,argv", [("device", []), ("device", ["--n-mels", "16"]), ("host", []),
                                          ("device", ["--stft-method", "matmul"])])
def test_audio_cli_on_a_wav_shorter_than_one_frame(backend, argv, tmp_path, host_backends, monkeypatch):
    """500 samples under a 1024-sample frame: both packages save the same empty figure, exit code 0."""
    import single_plot_audio_spectrogram as jcli

    from configurable_spectrograms_torch.cli import audio

    wav = str(tmp_path / "short.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes((3000 * np.sin(np.arange(500) / 5.0)).astype("<i2").tobytes())
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    out, ref = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert _run_main(monkeypatch, audio.main, ["--wav-file", wav, "--output", out, *argv]) == 0
    assert _run_main(monkeypatch, jcli.main, ["--wav-file", wav, "--output", ref, *argv]) == 0
    _same_pixels(out, ref)


@pytest.mark.parametrize("scales", [("linear", "linear", "viridis"), ("log", "log", "turbo")])
def test_single_cdf_cli_writes_the_jax_packages_pixels(scales, cdf_archive, tmp_path, host_backends, monkeypatch):
    import single_plot_spectrogram as jcli

    from configurable_spectrograms_torch.cli import single_plot_spectrogram as cli

    y, z, cmap = scales
    args = ["--cdf-file", cdf_archive["ies"], "--y-scale", y, "--z-scale", z, "--colormap", cmap]
    out, ref = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert _run_main(monkeypatch, cli.main, [*args, "--output", out]) == 0
    assert _run_main(monkeypatch, jcli.main, [*args, "--output", ref]) == 0
    _same_pixels(out, ref)


def _datasets_of(archive: dict, load):
    def build(item):
        if item == "nodata":
            return []
        d = load(archive[item])
        return [{"x": d["times"], "y": d["energy"], "data": d["data"], "label": item}]

    return build


def test_generic_batch_plot_writes_the_jax_packages_pixels(cdf_archive, tmp_path, host_backends):
    from configurable_spectrograms_tpu.data.cdf_utils import load_fast_cdf_dataset as jload
    from configurable_spectrograms_tpu.generic_batch import generic_batch_plot as jbatch
    from configurable_spectrograms_torch.data.cdf_utils import load_fast_cdf_dataset
    from configurable_spectrograms_torch.generic_batch import generic_batch_plot

    items = ["ees", "nodata", "ieb"]
    res = {}
    for name, batch, load in (("port", generic_batch_plot, load_fast_cdf_dataset), ("jax", jbatch, jload)):
        res[name] = batch(items, str(tmp_path / name), _datasets_of(cdf_archive, load), y_scale="log",
                          z_scale="log", colormap="inferno", max_workers=2,
                          progress_json_path=str(tmp_path / f"{name}.json"), flush_batch_size=1,
                          install_signal_handlers=False)
    assert dict(res["port"]) == dict(res["jax"]) == {"ees": "ok", "nodata": "no_data", "ieb": "ok"}
    for item in ("ees", "ieb"):
        _same_pixels(tmp_path / "port" / item / "generic.png", tmp_path / "jax" / item / "generic.png")
    assert not (tmp_path / "port" / "nodata").exists()
    port_state = json.loads((tmp_path / "port.json").read_text())
    jax_state = json.loads((tmp_path / "jax.json").read_text())
    assert set(port_state) == set(jax_state) == {"completed_items", "errors", "no_data", "last_index", "schema_version"}
    for k in port_state:
        got, want = port_state[k], jax_state[k]
        assert (sorted(got) == sorted(want)) if isinstance(got, list) else got == want, k


def test_resumed_generic_batch_skips_completed_items(cdf_archive, tmp_path, host_backends):
    from configurable_spectrograms_torch.data.cdf_utils import load_fast_cdf_dataset
    from configurable_spectrograms_torch.generic_batch import generic_batch_plot

    progress = str(tmp_path / "progress.json")
    calls = []
    build = _datasets_of(cdf_archive, load_fast_cdf_dataset)

    def counting(item):
        calls.append(item)
        return build(item)

    kw = dict(max_workers=2, progress_json_path=progress, flush_batch_size=1, install_signal_handlers=False)
    first = generic_batch_plot(["ees", "nodata", "eeb"], str(tmp_path / "out"), counting, **kw)
    assert sorted(calls) == ["eeb", "ees", "nodata"] and dict(first)["nodata"] == "no_data"
    calls.clear()
    second = generic_batch_plot(["ees", "nodata", "eeb", "ies"], str(tmp_path / "out"), counting, **kw)
    assert sorted(calls) == ["ies", "nodata"]  # ok items are skipped; no_data is retried
    assert dict(second) == {"nodata": "no_data", "ies": "ok"}
    state = json.loads(Path(progress).read_text())
    assert sorted(state["completed_items"]) == ["'eeb'", "'ees'", "'ies'"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["eeb", "ees", "ies"]


def test_run_batch_statuses_resume_and_worker_exception(tmp_path):
    from configurable_spectrograms_torch.batch_runner import run_batch

    progress = str(tmp_path / "p.json")
    factory = functools.partial(ThreadPoolExecutor, max_workers=2)

    def worker(item):
        if item == "boom":
            raise RuntimeError("boom")
        return (item, {"bad": "error", "empty": "no_data"}.get(item, "ok"))

    results = run_batch(["a", "bad", "empty", "boom", "b"], worker, factory, progress_json_path=progress,
                        flush_batch_size=1, install_signal_handlers=False)
    assert dict(results) == {"a": "ok", "bad": "error", "empty": "no_data", "boom": "error", "b": "ok"}
    state = json.loads(Path(progress).read_text())
    assert sorted(state["completed_items"]) == ["'a'", "'b'"]
    assert sorted(state["errors"]) == ["'bad'", "'boom'"]
    assert state["no_data"] == ["'empty'"] and state["last_index"] == 4
    calls = []
    run_batch(["a", "bad", "b"], lambda i: (calls.append(i), (i, "ok"))[1], factory,
              progress_json_path=progress, flush_batch_size=1, install_signal_handlers=False)
    assert calls == ["bad"]


@pytest.mark.parametrize(
    "argv,code",
    [
        (["--cdf-file", "{missing}", "--output", "{out}"], 1),
        (["--cdf-file", "{cdf}", "--output", "{out}"], 0),
        (["--output", "{out}"], 2),
        (["--cdf-file", "{cdf}", "--output", "{out}", "--z-scale", "sqrt"], 2),
    ],
)
def test_single_cdf_cli_exit_codes(argv, code, cdf_archive, tmp_path, host_backends, monkeypatch):
    from configurable_spectrograms_torch.cli import single_plot_spectrogram as cli

    subs = {"missing": str(tmp_path / "nope.cdf"), "out": str(tmp_path / "o.png"), "cdf": cdf_archive["ees"]}
    assert _run_main(monkeypatch, cli.main, [a.format(**subs) for a in argv]) == code
    assert os.path.exists(subs["out"]) == (code == 0)


@pytest.mark.parametrize("argv,code", [([], 0), (["--stft-method", "welch"], 2), (["--hop-length", "x"], 2)])
def test_audio_cli_exit_codes(argv, code, wav_file, tmp_path, host_backends, monkeypatch):
    from configurable_spectrograms_torch.cli import audio

    out = str(tmp_path / "a.png")
    assert _run_main(monkeypatch, audio.main, ["--wav-file", wav_file, "--output", out, *argv]) == code
    assert os.path.exists(out) == (code == 0)


def test_report_render_outcome(capsys):
    from configurable_spectrograms_torch.cli import report_render_outcome

    assert report_render_outcome(True, "x.png") == 0
    assert report_render_outcome(False, "x.png") == 1
    out = capsys.readouterr().out
    assert "[SAVED] x.png" in out and "[WARNING] No data available" in out


@pytest.mark.parametrize(
    "body,code,stderr",
    [
        ("return 0", 0, ""),
        ("return None", 0, ""),
        ("return 1", 1, ""),
        ("raise KeyboardInterrupt", 130, ""),
        ("sys.exit('boom: bad input')", 1, "boom: bad input"),
        ("sys.exit(2)", 2, ""),
    ],
)
def test_run_cli_exit_codes_in_a_subprocess(body, code, stderr, tmp_path):
    """``run_cli`` ends in ``os._exit``, so it runs in a child process (as tests/test_cli_entry_points.py does)."""
    script = (
        "import sys\n"
        "from configurable_spectrograms_torch.cli.common import run_cli\n"
        f"def main():\n    {body}\n"
        "run_cli(main)\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, cwd=tmp_path,
                          env=env, timeout=120)
    assert proc.returncode == code, (proc.returncode, proc.stderr)
    assert stderr in proc.stderr
    assert ("[INTERRUPT]" in proc.stdout) == (code == 130)
    assert "jax" not in proc.stderr


def test_audio_cli_as_a_module_on_the_cpu(wav_file, tmp_path):
    """``CST_TORCH_DEVICE=cpu python -m configurable_spectrograms_torch.cli.audio ...`` (pallas method)."""
    env = dict(os.environ, CST_TORCH_DEVICE="cpu", CST_RENDER_BACKEND="device", OMP_NUM_THREADS="1",
               PYTHONPATH=f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    out = tmp_path / "m.png"
    proc = subprocess.run(
        [sys.executable, "-m", "configurable_spectrograms_torch.cli.audio", "--wav-file", wav_file,
         "--output", str(out), "--n-mels", "24", "--stft-method", "pallas", "--frame-length", "512"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"[SAVED] {out}" in proc.stdout and _pixels(out).shape[0] > 0


@pytest.mark.parametrize("backend", ["device", "host"])
def test_recommended_workers(backend, monkeypatch):
    from configurable_spectrograms_torch.render import compositor
    from configurable_spectrograms_torch.render.backend import recommended_workers

    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    monkeypatch.delenv("CST_CANVAS_POOL_PER_SIZE", raising=False)
    monkeypatch.setattr(compositor, "_CANVAS_POOL_MAX_PER_SIZE", 4)
    cores = len(os.sched_getaffinity(0))
    want = 1000 if backend == "device" else min(1000, cores)
    assert recommended_workers(1000) == want
    assert compositor._CANVAS_POOL_MAX_PER_SIZE == max(4, want)
    assert recommended_workers(0) == 1


def test_progress_store_and_helpers_match_the_jax_package(tmp_path):
    from configurable_spectrograms_tpu.utils import progress as jprogress
    from configurable_spectrograms_torch.utils import progress

    assert progress.new_generic_progress() == jprogress.new_generic_progress()
    for mod in (progress, jprogress):
        d = {}
        for orbit in (5, 3, 5, 9):
            mod.add_to_orbit_list(d, "errors", orbit)
        assert d == {"errors": [3, 5, 9]}
    path = tmp_path / "p.json"
    store = progress.ProgressStore(str(path), flush_batch_size=2)
    store.load(progress.new_generic_progress())
    store["completed_items"].append("'a'")
    store.mark_dirty()
    assert not path.exists()  # below the flush threshold
    store.mark_dirty()
    assert json.loads(path.read_text())["completed_items"] == ["'a'"]
    with progress.ProgressStore(str(path)) as again:
        again.load({})
        assert again.get("completed_items") == ["'a'"] and "last_index" in again
        again.setdefault("extra", 1)
    assert json.loads(path.read_text())["extra"] == 1
    path.write_text("{torn")
    assert progress.ProgressStore(str(path)).load({"k": 1}) == {"k": 1}
    assert progress.ProgressStore(None).load({"k": 2}) == {"k": 2}


def test_logging_helpers_match_the_jax_package(tmp_path):
    from configurable_spectrograms_tpu.utils import logging as jlogging
    from configurable_spectrograms_torch.utils import logging as tlogging

    marker = tmp_path / "marker.txt"
    first = tlogging.get_logfile_path(str(tmp_path / "run"), str(marker))
    assert first == jlogging.get_logfile_path(str(tmp_path / "run"), str(marker))
    assert first == tlogging.get_logfile_path(str(tmp_path / "run"), str(marker))  # the marker is reused
    log = tmp_path / "batched.log"
    tlogging.set_logfile_path(str(log))
    try:
        tlogging.configure_log_batch(3)
        tlogging.log_message("one")
        tlogging.log_message("two")
        assert not log.exists()
        tlogging.log_message("three")
        assert log.read_text().splitlines() == ["one", "two", "three"]
    finally:
        tlogging.configure_log_batch(10)
        tlogging.flush_log_buffer()
        tlogging.set_logfile_path(None)
