"""``chip_smoke.py``'s ``[sanitize]`` phase on the CPU: its case list, its guards and its reading of
compute-sanitizer's report.

On the card the phase launches every case through the kernel wrappers under compute-sanitizer, and
again between poisoned guard zones.  Here the case list is built as the card builds it: it holds the
tail cases of every launch configuration, and each case, run through the plain versions (what the
CPU wrappers run), matches the JAX package -- the collapse exactly (A <= 32 in every tail case), the
fused quantize as in the sweep's parity test (vmin and col_all_nan exact, each index exact or one bin
apart on a proven boundary), stft_power within the kernel's tolerance, and the mixed-bucket render's
bounds and errors bit for bit.  The guards and the report parser are held to faults made on purpose.
"""

import dataclasses
import json
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
CPU = torch.device("cpu")

TAIL_CASES = (
    "bucket_8_lanes_log", "bucket_8_lanes_linear", "two_cubes_interleaved_log", "two_cubes_interleaved_linear",
    "11_lanes_one_cube_log", "11_lanes_one_cube_linear", "no_positive_value_log", "no_positive_value_linear",
    "extrema_4_cubes", "t_tail", "e_4", "e_1", "e_260", "e_261", "one_lane",
    "19_lanes_3_cubes", "stft_L1024_hop256_F2000", "stft_L8192_hop2048_F64", "stft_L1000_hop250_F600",
    "stft_L1000_hop200_F600", "stft_L8_hop3_F1500", "stft_L8_hop8_F1500", "render_mixed_bucket",
)


@pytest.fixture(scope="module")
def tail_cases():
    return dict(chip_smoke.sanitize_tail_cases())


def test_the_case_list_holds_the_tail_cases(tail_cases):
    assert tuple(tail_cases) == TAIL_CASES
    lanes = {n: c for n, c in tail_cases.items() if c.get("cubes") is not None}
    for name in ("bucket_8_lanes_log", "extrema_4_cubes", "one_lane"):
        assert lanes[name]["cubes"].shape[1:] == chip_smoke.SANITIZE_SHAPE
    t = lanes["t_tail"]
    assert t["cubes"].shape[1] % 2 == 1 and (t["t_valid"] < t["cubes"].shape[1]).any()
    widths = {c["cubes"].shape[3] for c in lanes.values()}
    assert {1, 4} <= widths  # one column vector, at either vector width
    assert {260, 261} <= widths  # a vector count off 64 and 256 threads, at either width
    assert any(len(c["u_idx"]) == 1 for c in lanes.values())
    many = lanes["19_lanes_3_cubes"]
    assert len(many["u_idx"]) == 19 and set(many["u_idx"].tolist()) == {0, 1, 2}
    assert np.any(np.diff(many["u_idx"]) < 0)  # interleaved
    assert any((~c["masks"]).all(axis=1).any() for c in lanes.values())  # an empty pitch mask
    assert any((c["t_valid"] == 0).any() for c in lanes.values())  # a lane with no file rows
    stft = {(c["stft"]["L"], c["stft"]["hop"]) for c in tail_cases.values() if c.get("stft")}
    assert {(1000, 200), (1000, 250), (8, 3), (8, 8)} <= stft
    assert all(c["stft"]["F"] <= 2000 for c in tail_cases.values() if c.get("stft"))
    panels = tail_cases["render_mixed_bucket"]["panels"]
    assert {p.z_min is not None for p in panels} == {True, False}  # the fused and the collapse route in one call
    names = [n for n, _ in chip_smoke.sanitize_cases(3, 2)]
    assert names[: len(TAIL_CASES)] == list(TAIL_CASES)
    assert names[len(TAIL_CASES):] == [f"sweep_{s}" for s in (*chip_smoke.SWEEP_PINNED_SEEDS, 3, 4)]


def _pad(cube: np.ndarray) -> np.ndarray:
    T, A, E = cube.shape
    out = np.full((-(-T // 64) * 64, A, -(-E // 128) * 128), np.nan, np.float32)
    out[:T, :, :E] = cube
    return out


def _hold_lanes_to_jax(case: dict) -> None:
    from configurable_spectrograms_tpu.ops.pallas_kernels import collapse_cube_pallas, fused_quantize_pallas

    U, T, A, E = case["cubes"].shape
    assert A <= 32  # exact against XLA:CPU's in-order sum
    got = chip_smoke.sanitize_launch(K, case, "collapse", CPU)[0].numpy()
    idx, vmin, col_all_nan = (t.numpy() for t in chip_smoke.sanitize_launch(K, case, "fused_quantize", CPU))
    padded = [jnp.asarray(_pad(c)) for c in case["cubes"]]
    z = case["z_scale"]
    for j, u in enumerate(case["u_idx"].tolist()):
        mask, tv = case["masks"][j], int(case["t_valid"][j])
        want = np.asarray(collapse_cube_pallas(padded[u], jnp.asarray(mask), tv))[:T, :E]
        np.testing.assert_array_equal(got[j], want, err_msg=f"collapse, lane {j}")
        ev = np.zeros(padded[u].shape[2], bool)
        ev[:E] = case["e_valid"][j]
        ref = fused_quantize_pallas(padded[u], jnp.asarray(mask), jnp.asarray(ev), tv, int(case["t_start"][j]),
                                    int(case["t_count"][j]), jnp.asarray(case["z_bounds"][j]), z_scale=z)
        assert vmin[j] == float(ref["vmin"]), f"lane {j}"
        np.testing.assert_array_equal(col_all_nan[j], np.asarray(ref["col_all_nan"])[:E])
        d = np.abs(idx[j].astype(int) - np.asarray(ref["idx"])[:T, :E].astype(int))
        assert d.max(initial=0) <= 1, f"lane {j}: {d.max()} bins apart"
        with np.errstate(all="ignore"):
            on = chip_smoke.boundary_mask(got[j], float(ref["vmin"]), float(case["z_bounds"][j, 1]), z, d > 0)
        assert on.sum() == (d > 0).sum(), f"lane {j}: {(d > 0).sum() - on.sum()} cells off a bin boundary"


def _hold_stft_to_jax(case: dict) -> None:
    from configurable_spectrograms_tpu.ops.pallas_kernels import stft_power_pallas
    from configurable_spectrograms_torch.ops.stft import _dft_bases, frame_signal

    s = case["stft"]
    got = chip_smoke.sanitize_launch(K, case, "stft_power", CPU)[0]
    frames = frame_signal(torch.from_numpy(s["signal"]), s["L"], s["hop"]).numpy()
    cos_b, sin_b = _dft_bases(s["L"])
    F, Kb = s["F"], cos_b.shape[1]
    assert tuple(got.shape) == (F, Kb)
    Fp, Kp = -(-F // 128) * 128, -(-Kb // 128) * 128
    want = np.asarray(stft_power_pallas(np.pad(frames, ((0, Fp - F), (0, 0))),
                                        np.pad(cos_b, ((0, 0), (0, Kp - Kb))), np.pad(sin_b, ((0, 0), (0, Kp - Kb))),
                                        128, 128, interpret=True))[:F, :Kb].copy()
    ratio, _ = chip_smoke.stft_ratio(torch.from_numpy(want), got)
    assert float(ratio.max()) <= 1.0


def _hold_render_to_jax(case: dict, monkeypatch) -> None:
    from configurable_spectrograms_tpu.render import dispatch as jax_dispatch
    from configurable_spectrograms_tpu.render import link
    from configurable_spectrograms_tpu.render.panel import PanelData as JaxPanel
    from configurable_spectrograms_tpu.render.tile import TimeWindow as JaxWindow
    from configurable_spectrograms_torch.render.dispatch import device_render_panels

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", "device")
    panels = case["panels"]
    port = device_render_panels(panels, 48, 64)
    jax_panels = [JaxPanel(**{**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)},
                              "window": JaxWindow(**dataclasses.asdict(p.window))}) for p in panels]
    mode = link._BACKEND["mode"]
    link._BACKEND["mode"] = "device"
    try:
        ref = jax_dispatch.device_render_panels(jax_panels, 48, 64)
    finally:
        link._BACKEND["mode"] = mode
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.get("error") == b.get("error"), f"panel {i}"
        if "error" not in a:
            for k in ("vmin", "vmax", "y0", "y1", "n_kept", "empty"):
                assert np.float32(a[k]).tobytes() == np.float32(b[k]).tobytes(), f"panel {i} {k}"


@pytest.mark.parametrize("name", TAIL_CASES)
def test_tail_case_matches_the_jax_package_and_passes_its_guards(name, tail_cases, monkeypatch):
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    case = tail_cases[name]
    if case.get("cubes") is not None:
        _hold_lanes_to_jax(case)
    if case.get("stft") is not None:
        _hold_stft_to_jax(case)
    if case.get("panels") is not None:
        _hold_render_to_jax(case, monkeypatch)
    for kernel in chip_smoke.case_kernels(case):
        assert chip_smoke.guard_check(K, case, kernel, CPU) == [], kernel


def test_guard_sees_a_write_past_a_buffer():
    guard = chip_smoke.Guard(CPU, 0x5A)
    t = guard.empty((3, 5), torch.float32)
    assert (t.view(torch.uint8) == 0x5A).all() and guard.breaches() == 0
    t.fill_(1.0)
    assert guard.breaches() == 0
    buf, n = guard.zones[0]
    buf[chip_smoke.GUARD_BYTES + n + 7] = 0  # one byte past the tensor
    buf[chip_smoke.GUARD_BYTES - 1] = 0  # one byte before it
    assert guard.breaches() == 2


def test_guard_sees_an_input_nothing_wrote(monkeypatch):
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    outs = []
    for fill in chip_smoke.GUARD_FILLS[:2]:
        guard = chip_smoke.Guard(CPU, fill)
        outs.append(chip_smoke.sanitize_control(K, "unwritten_input", CPU, guard)[0].numpy().tobytes())
    assert outs[0] != outs[1]


def test_guard_check_reports_an_output_that_follows_the_poison(monkeypatch):
    """A wrapper whose output keeps an unwritten cell (the fault initcheck looks for) fails guard_check."""
    case = chip_smoke.lanes_case(np.ones((1, 8, 2, 4), np.float32), [0], np.ones((1, 2), bool), [8])
    real = chip_smoke.sanitize_launch

    def leaky(K_, case_, kernel, device, place=None):
        out = real(K_, case_, kernel, device, place)
        hole = K_._empty((1,), torch.float32, device)  # the poison, never written
        return [torch.cat([out[0].flatten(), hole])] if kernel == "collapse" else out

    monkeypatch.setattr(K, "_empty", K._empty)
    monkeypatch.setattr(chip_smoke, "sanitize_launch", leaky)
    assert any("differs between the poisons" in f for f in chip_smoke.guard_check(K, case, "collapse", CPU))
    assert chip_smoke.guard_check(K, case, "fused_quantize", CPU) == []


MEMCHECK = """========= COMPUTE-SANITIZER
========= Invalid __global__ write of size 16 bytes
=========     at void cst_collapse_kernel<(int)4>(const float *, const int *, const unsigned char *, const int *, float *, int, int, int, int)+0x4d0 in configurable_spectrograms_torch/csrc/collapse_common.cuh:168
=========     by thread (60,0,0) in block (15,2,0)
=========     Address 0x7f3a4c001f80 is out of bounds
=========     and is 1 bytes after the nearest allocation at 0x7f3a4c000000 of size 12096 bytes
=========     Saved host backtrace up to driver entry point at kernel launch time
=========         Host Frame: cst_collapse [0x1b2c] in libcst_kernels_0123456789abcdef.so
=========\x20
========= Invalid __global__ read of size 4 bytes
=========     at void cst_stft_power_kernel<(bool)0>(const float *, long long, int, int, const float *, int, int, int, int, int, float *)+0x2a0 in configurable_spectrograms_torch/csrc/stft_power.cu:150
=========     by thread (3,0,0) in block (0,0,0)
=========\x20
========= ERROR SUMMARY: 2 errors
"""

RACECHECK = """========= COMPUTE-SANITIZER
========= Error: Race reported between Write access at void cst_fused_stats_kernel<(int)4>(const float *, const int *, const unsigned char *, const unsigned char *, const int *, const int *, const int *, float *, int *, unsigned int *, int *, int, int, int, int)+0x9e0 in configurable_spectrograms_torch/csrc/fused_quantize.cu:121
=========     and Read access at void cst_fused_stats_kernel<(int)4>(...)+0xa40 in configurable_spectrograms_torch/csrc/fused_quantize.cu:131 [248 hazards]
=========\x20
========= Warning: Race reported between Write access at void cst_collapse_kernel<(int)4>(...)+0x100 in configurable_spectrograms_torch/csrc/collapse_common.cuh:84
=========     and Write access at void cst_collapse_kernel<(int)4>(...)+0x100 in configurable_spectrograms_torch/csrc/collapse_common.cuh:84 [31 hazards]
=========\x20
========= RACECHECK SUMMARY: 2 hazards displayed (1 error, 1 warning)
"""

UNSUPPORTED = """========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
=========\x20
========= Program hit cudaErrorUnknown (error 999) due to "unknown error" on CUDA API call to cudaMalloc.
=========     Saved host backtrace up to driver entry point at error
=========\x20
========= ERROR SUMMARY: 3 errors
"""

CLEAN = """========= COMPUTE-SANITIZER
========= ERROR SUMMARY: 0 errors
"""


@pytest.mark.parametrize("text, unsupported, summary, records", [
    (MEMCHECK, False, 2, [("error", "collapse"), ("error", "stft_power")]),
    (RACECHECK, False, 1, [("error", "fused_quantize"), ("warning", "collapse")]),
    (UNSUPPORTED, True, 3, [("error", "other")]),
    (CLEAN, False, 0, []),
])
def test_parse_sanitizer_reads_each_record(text, unsupported, summary, records):
    got = chip_smoke.parse_sanitizer(text)
    assert got["unsupported"] is unsupported and got["summary_errors"] == summary
    assert [(sev, k) for sev, k, _ in got["records"]] == records
    assert all(t.splitlines()[0] and "=" not in t[:1] for _, _, t in got["records"])


def _stub_child(results: dict):
    def run(tool, spec, log_dir):
        name = spec.get("control") or "cases"
        text = results[(tool, name)]
        log = Path(log_dir) / f"{tool}_{name}.log"
        log.write_text(text)
        child = {} if spec.get("control") else {"kernels": {"collapse": {"cases": 2, "launches": {"collapse": 2},
                                                                         "seconds": 0.1}}}
        rc = chip_smoke.SANITIZE_EXIT if "ERROR SUMMARY: 0" not in text else 0
        return {"rc": rc, "seconds": 0.5, "log": str(log), "child": child, **chip_smoke.parse_sanitizer(text)}
    return run


def _controls_caught():
    return {("memcheck", "short_output"): MEMCHECK, ("initcheck", "unwritten_input"): MEMCHECK}


@pytest.fixture
def phase(monkeypatch, tmp_path):
    """run_sanitize on the CPU over two sweep seeds: the guards run for real; the short-output control
    (the kernels' C entry point) and the sanitizer children are stand-ins."""
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "sanitize_tail_cases", lambda: [])
    monkeypatch.setattr(chip_smoke, "lineinfo_sass", lambda: {"identical": True, "lines": 9, "lines_differing": 0})
    real = chip_smoke.sanitize_control

    def control(K_, name, device, guard=None):
        if name == "short_output":  # the C entry point: a write one past the guarded output
            out = guard.empty((4,), torch.float32)
            guard.zones[-1][0][chip_smoke.GUARD_BYTES + 16] = 0
            return [out.fill_(0.0)]
        return real(K_, name, device, guard)

    monkeypatch.setattr(chip_smoke, "sanitize_control", control)
    monkeypatch.setattr(chip_smoke, "__file__", str(tmp_path / "chip_smoke.py"))
    return monkeypatch


def test_run_sanitize_passes_when_every_tool_is_clean(phase, capsys):
    phase.setattr(chip_smoke, "run_sanitizer_child", _stub_child(
        {**_controls_caught(), ("memcheck", "cases"): CLEAN, ("racecheck", "cases"): CLEAN}))
    got = chip_smoke.run_sanitize(CPU, 0, 2)
    assert got["compute_sanitizer"] and set(got["guard"]) == {"collapse", "fused_quantize", "stft_power",
                                                              "percentile_quantize"}
    out = capsys.readouterr().out
    assert "[sanitize] tool=memcheck kernel=collapse cases=2 launches=2 errors=0" in out
    assert "[sanitize] control=short_output tool=guard errors=1" in out
    assert "[sanitize] control=unwritten_input tool=guard errors=1" in out


@pytest.mark.parametrize("fault", ["error_record", "silent_control", "crashed_child", "sass_differs"])
def test_run_sanitize_fails(fault, phase):
    results = {**_controls_caught(), ("memcheck", "cases"): CLEAN, ("racecheck", "cases"): CLEAN}
    if fault == "sass_differs":
        phase.setattr(chip_smoke, "lineinfo_sass", lambda: {"identical": False, "lines": 9, "lines_differing": 1})
    if fault == "error_record":
        results[("racecheck", "cases")] = RACECHECK
    elif fault == "silent_control":
        results[("initcheck", "unwritten_input")] = CLEAN
    run = _stub_child(results)
    if fault == "crashed_child":
        def run(tool, spec, log_dir, _run=_stub_child(results)):
            r = _run(tool, spec, log_dir)
            return dict(r, rc=-11, child={}) if tool == "memcheck" and not spec.get("control") else r
    phase.setattr(chip_smoke, "run_sanitizer_child", run)
    with pytest.raises(AssertionError, match=r"\[sanitize\]"):
        chip_smoke.run_sanitize(CPU, 0, 2)


def test_run_sanitize_where_the_tool_cannot_attach_says_so_and_keeps_the_guards(phase, capsys):
    calls = []

    def run(tool, spec, log_dir, _run=_stub_child({("memcheck", "short_output"): UNSUPPORTED})):
        calls.append((tool, spec.get("control")))
        return _run(tool, spec, log_dir)

    phase.setattr(chip_smoke, "run_sanitizer_child", run)
    got = chip_smoke.run_sanitize(CPU, 0, 2)
    assert calls == [("memcheck", "short_output")]  # no further child once the tool said so
    out = capsys.readouterr().out
    assert out.count("status=unsupported") == len(chip_smoke.SANITIZE_TOOLS)
    assert not got["compute_sanitizer"] and got["guard"]


def test_a_missing_compute_sanitizer_fails_the_phase(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(AssertionError, match="compute-sanitizer is not in"):
        chip_smoke.compute_sanitizer()


def test_the_child_reports_what_it_launched(monkeypatch, tmp_path):
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "sanitize_tail_cases", lambda: [])
    report = tmp_path / "r.json"
    assert chip_smoke.sanitizer_child({"seeds": [0, 2], "report": str(report)}) == 0
    got = json.loads(report.read_text())["kernels"]
    n = 2 + len(chip_smoke.SWEEP_PINNED_SEEDS)
    assert {k: v["cases"] for k, v in got.items()} == {"collapse": n, "fused_quantize": n, "stft_power": n,
                                                       "percentile_quantize": n}
