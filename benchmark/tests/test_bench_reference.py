"""The reference agrees with the port on a tiny archive and a tiny recording (the port's CPU path)."""

from __future__ import annotations

import json

from bench_helpers import run_cell


def _checks(result: dict) -> dict:
    return {k: v["value"] for k, v in result["checks"].items()}


def test_flagship_pass_matches_the_reference():
    code, result = run_cell("fast_esa_l2.sample_orbits")
    assert code == 0 and result is not None
    c = _checks(result)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] == 40
    assert c["pngs_missing_or_extra"] == 0 and c["extrema_values_off"] == 0 and c["tiles_missing"] == 0
    assert c["tile_pixels_off_pct"] == 0.0 and c["tile_max_bins_off"] == 0
    assert c["decodes_per_file_min"] >= 1 and c["given_extrema_figures_judged"] >= 1
    assert set(result["metrics"]) == {"setup_s", "peak_rss_gib"}
    assert list(result)[-1] == "checks"


def test_audio_figures_match_the_reference():
    code, result = run_cell("audio_wav.clips_5s", seconds=0.5)
    assert code == 0 and result is not None
    c = _checks(result)
    assert result["correct"] and result["attempted"] >= 2
    assert c["figures_missing"] == 0 and c["stft_err_ratio"] < 0.05 and c["figures_rows_compared"] >= 1
    assert c["tile_pixels_off_pct"] < 0.05 and c["tile_max_bins_off"] <= 1
    assert set(result["metrics"]) == {"setup_s", "peak_rss_gib"}


def test_device_trace_summary_reads_busy_time_gaps_and_operations(tmp_path):
    """The union of device intervals, the gaps named by the host span open then, seconds by name."""
    from harness.trace import DeviceTrace, Recorder

    rec = Recorder()
    rec.spans += [("prepass", 100.0, 100.010), ("render", 100.010, 100.100)]
    trace = DeviceTrace(str(tmp_path))
    trace.t_anchor, trace.t_end = 100.0, 100.100
    events = [{"cat": "kernel", "name": "spin_kernel", "ts": 5000.0, "dur": 1.0},
              {"cat": "kernel", "name": "cst_collapse_kernel", "ts": 5002.0, "dur": 3000.0},
              {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 6000.0, "dur": 3000.0},
              {"cat": "cpu_op", "name": "aten::add", "ts": 5000.0, "dur": 90000.0},
              {"cat": "kernel", "name": "cst_fused_map_kernel", "ts": 50000.0, "dur": 10000.0}]
    (tmp_path / "device_trace.json").write_text(json.dumps({"traceEvents": events}))
    s = trace.summary(rec)
    assert abs(s["busy_s"] - 0.013998) < 1e-9 and abs(s["window_s"] - 0.1) < 1e-12
    assert s["device_ops"][0][0] == "cst_fused_map_kernel"
    assert [n for n, _ in s["idle_gaps"][:2]] == ["render", "render"]
    assert abs(s["idle_gaps"][0][1] - 0.045) < 1e-9 and abs(s["idle_gaps"][1][1] - 0.041) < 1e-9


def test_idle_gaps_are_named_by_the_innermost_port_stage(tmp_path):
    """A gap takes the latest-started stage of any thread open at its midpoint, else the driver's span."""
    from configurable_spectrograms_torch.utils.timing import StageTimer
    from harness.trace import DeviceTrace, Recorder

    rec = Recorder()
    rec.spans += [("figure", 100.0, 100.1)]
    timer = StageTimer("synthetic")
    timer.intervals += [("wav_load", 100.000, 100.025, 1), ("mel_filterbank", 100.015, 100.024, 1),
                        ("render_wait", 100.040, 100.060, 1), ("device_dispatch", 100.045, 100.058, 2),
                        ("composite", 100.061, 100.080, 1)]
    trace = DeviceTrace(str(tmp_path))
    trace.t_anchor, trace.t_end = 100.0, 100.1
    busy = [(100.010, 100.012), (100.030, 100.031), (100.070, 100.071)]
    events = [{"cat": "kernel", "name": "spin_kernel", "ts": 5000.0, "dur": 1.0}]
    events += [{"cat": "kernel", "name": "k", "ts": 5000.0 + (t0 - 100.0) * 1e6, "dur": (t1 - t0) * 1e6}
               for t0, t1 in busy]

    def gaps(timer):
        (tmp_path / "device_trace.json").write_text(json.dumps({"traceEvents": events}))
        return [(n, round(s, 6)) for n, s in trace.summary(rec, timer)["idle_gaps"]]

    assert gaps(timer) == [("device_dispatch", 0.039), ("figure", 0.029), ("mel_filterbank", 0.018),
                           ("wav_load", 0.01)]
    assert gaps(None) == [("figure", 0.039), ("figure", 0.029), ("figure", 0.018), ("figure", 0.01)]
