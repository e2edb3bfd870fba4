"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py            # the whole check (one GPU)
    python3 chip_smoke.py --kernels  # build + kernel parity and timing only;
                                     # its records carry "launches": null

Phases, one line each, in order:

1. device   -- the card's name and power limit (nvidia-smi), which of PIL,
               pandas, matplotlib and tqdm import; requires
               torch.cuda.is_available().
2. build    -- compiles ``configurable_spectrograms_torch/csrc/*.cu`` with nvcc,
               one process per source, all started together.
3. kernel   -- each kernel against its plain PyTorch version on the card:
               collapse and fused_quantize at 8192x64x128 and 2048x32x48
               (seeded inputs with NaN and +/-inf cells, t_valid < T, partial
               pitch masks, a time window, both z scales); both also on two
               cubes with interleaved lanes and on more lanes of one cube
               than a lane group holds; fused_quantize also with lanes whose
               window holds no finite positive value (the 1e-10 floor) and a
               lane with no file rows, and with its two launches timed apart
               (does the quantize find the scratch in L2?); the collapse also
               in the extrema layout (four all-pitch lanes, one a cube,
               different t_valid) beside torch.nansum; stft_power on 600 s
               of seeded 44.1 kHz audio at L = 1024, hop = 256 (F = 103,356,
               K = 513) and L = 8192, hop = 2048 (F = 12,916, K = 4097), and
               on 30 s of it at
               L = 1000 with hop = 250 (4-byte copies) and hop = 200 (an L
               tail), within |a - b| <= 1e-4 * max(|a|, 1e-3 * max|a|) + 1e-2
               of the plain version, and (L = 1024 and L = 1000) with a float64
               error within 4x the plain version's; cuBLAS (two matmuls on a
               contiguous copy of the frames) timed beside it.  CUDA-event
               timings: the median of 5 windows of 4 back-to-back calls after
               warm-up (plain versions: 2 windows).  Each [kernel] line has
               bound_ms (the larger of bytes / 3.35 TB/s and, for stft_power,
               3 x 4FKL / 495 TFLOP/s), bound_share and library_ms.
   font     -- the golden pitch grid (tests/goldens/fast_pitch_grid_200dpi.png,
               the inputs of tests/test_golden_figures.py) on the host
               backend: the font file must be a real one (the port's bundled
               DejaVuSans.ttf) and the render may differ from the golden in
               at most 2% of the canvas.
   png      -- that 4800x2400 canvas through the native encoder (its
               library, build variant, and whether text blends natively or
               by Image.paste) and through PIL at compress_level=3: ms and
               bytes of each; the two files must decode to the same pixels.
4. e2e      -- a synthetic archive (3 orbits at 2048x32x48, 1 orbit at
               8192x64x128, 4 instruments): the extrema pre-pass and the
               log/log per-orbit render on the device, then again with
               CST_RENDER_BACKEND=host; every panel's bounds must agree bit
               for bit and its index cells exactly, or one bin apart on a
               provable bin boundary; both kernels must have launched during
               the device run.  Per orbit, a [breakdown] line: the first
               device dispatch's seconds and its upload telemetry (h2d_bytes,
               cube-cache hits and misses), then a second device render of
               the same figures with its composite and PNG seconds (stage
               timers) and telemetry, whose h2d_bytes must not exceed one
               padded copy of each of the orbit's cubes
               (render_minus_dispatch_s: the second render's seconds less
               the first dispatch's, the composite figure of versions of
               this script without stage timers).
5. generic  -- the single-CDF CLI on the 8192x64x128 file and
               generic_batch_plot over the archive's 16 files, on the device
               backend: exit 0 and one PNG per item.
   batch    -- the flagless flagship CLI
               (``cli.batch_multi_plot_FAST_spectrograms.main()``, its
               defaults: 4 scale combos orbit-major, a 99th-percentile
               extrema pre-pass, 4 worker threads, existing plots skipped)
               in a working directory holding ./FAST_data (the archive) and
               ./FAST_Cusp_Indices.csv, on the device backend: every result
               ok, 4 orbits x 4 combos x 10 = 160 PNGs, the 4 progress
               cursors with no error or timeout, the extrema JSON, both
               kernels launched.  Run again, it must add, rewrite and launch
               nothing (resume).  Then on the host backend in a second
               tree: the same file list, the same extrema JSON, every
               raw-named PNG identical or differing only in pixels one
               colormap bin apart.  Then on the device backend again with
               the render back end off (CST_RENDER_COALESCE=0,
               CST_DEVICE_CUBE_CACHE=0, CST_HOST_COMPUTE_GATE=0): the same
               file list and extrema JSON, its panels/s beside the default
               run's.  Each batch line carries its upload telemetry; the
               default run must reuse a resident cube.  Then the single FAST CLI on the device
               backend: --cdf-file (the 8192x64x128 ees file), --data-folder
               with --orbit, and --instrument-file for all four instruments
               (--date needs the network and is not run).
   gui      -- the port's front-end
               (``cli.GUI_batch_download_plot_FAST``), after [batch] on the
               same archive.  The Qt pages run ``run_qt()`` on the headless
               stand-in; each action starts a spawned child (this process
               has started CUDA), whose target is wrapped in a probe that
               runs the real target and reports the child's launches and
               device.  (a) Single Day, the 8192x64x128 orbit,
               log-log-inferno, from the [batch] device tree (its
               ./FAST_Cusp_Indices.csv): "Finished.", the child on
               cuda:0 with collapse launches, pixels equal to the single
               FAST CLI's --data-folder PNG.  (b) Plot, one combo
               (log-log), percentile 99, into a fresh tree: the progress
               label shows "log_log @ orbit ...", "Finished.", both kernels
               launched in the child, the file list equal to the [batch]
               device tree's log_log subset, every raw-named PNG
               pixel-equal; the extrema JSON equal to that tree's
               linear_linear entries under log_log names (a fresh log_log
               pre-pass scans in linear space and caches what [batch]'s
               first combo cached; [batch]'s log_log entries are derived
               from them, as in the JAX package).  (c) Plot of log-log and
               linear-log into another fresh tree, Stop at the first
               progress line (log_log done; the child still working):
               "Stopped.", the child gone (and off nvidia-smi's compute
               apps) within 10 s; Plot again: "Finished.", the log_log
               files of (b) and [batch]'s linear_log files, no *.tmp-*
               file.  (d) ``python -m ... --tui``: Single Day,
               pitch-angle, the 8192x64x128 ees file: exit 0, "Done.",
               pixels equal to the single FAST CLI's --cdf-file PNG.
               Seconds of each action: press to the child's exit and to
               the status, and the child's boot, torch import, port
               import, CUDA context, kernel library load, the target's
               module import and the target (with its composite, PNG and
               readback stage seconds).  The
               children's launches join the kernels JSON line.
   parallel -- the parallel layer (one process per GPU, torch.distributed),
               after [batch] on the same archive; ranks are spawned
               processes (start method spawn) and report their launch
               counts themselves.
               (a) two Gloo ranks on the one card (LOCAL_RANK 0 each):
               sharded_extrema_stats on 8 cubes of 8192x64x128 (2.15 GB, a
               memory-mapped .npy; each rank reads its 1.07 GB block), some
               with t_valid < T, once on a ('data',) mesh of 2 and once on a
               ('data', 'time') mesh of 1x2: counts and histogram bit-equal
               to one process's batched_file_stats, collapse launches > 0 in
               each rank, the seconds of each mesh.
               (b) one NCCL rank through init_distributed() with torchrun's
               variables: the flagship CLI as in [batch] (one all_reduce
               first); the same file list and extrema JSON as the ungrouped
               device run, its render and extrema pre-pass on cuda:0.
               (c) two Gloo ranks on the one card running the flagship CLI at
               one worker thread on the three 2048x32x48 orbits, against one
               process at one worker: the union of their PNGs decodes to the
               same pixels, the ranks' .proc extrema JSONs are equal (and
               equal the one process's); written panels/s of 1 and 2 ranks
               (one card: informative only).
               (d) entry()'s forward on the card against the CPU's: bounds
               bit for bit, index cells and tile pixels within one bin on a
               provable bin boundary.
               (e) with two or more cards, dryrun_multichip(2, "nccl"): each
               rank on cuda:{rank}; with one card the line says
               nccl_two_cards=not_run.
6. audio    -- the same 600 s of audio as a 16-bit WAV (a 50 Hz - 15 kHz
               chirp, two tones, noise at -30 dB) through
               ``python -m configurable_spectrograms_torch.cli.audio``'s main on
               the device backend: --stft-method pallas raw and --n-mels 128,
               then fft and matmul raw.  Each device spectrogram within the
               stft_power tolerance of the numpy host STFT; the host-computed
               dataset (raw and mel) rendered on both backends with bounds bit
               for bit; stft_power and collapse launched in that phase;
               stft / dispatch / composite / PNG seconds; the second render
               of the figure must ship 0 bytes (its padded cube resident).

    python3 chip_smoke.py --backend-switches N

builds the kernels, makes the e2e phase's archive and runs the flagship
batch on the device backend N times in turn with the render back end on,
with each of its switches off alone (CST_DEVICE_CUBE_CACHE=0,
CST_RENDER_COALESCE=0, CST_HOST_COMPUTE_GATE=0) and with all three off
(the order rotates each round): one [switches] line per run, the same
file list and extrema JSON in every run, then the median panels/s of
each setting.  It prints no ok line.

Any failure raises (non-zero exit).  The last three lines are the card's
nvidia-smi line, a JSON line with one record per kernel, and the result
``{"ok": true, "device": {...}}``.  Needs no network; the kernels are built
from the checkout into ``build/cst_torch/``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SHAPES = ((8192, 64, 128), (2048, 32, 48))
AUDIO_SECONDS, AUDIO_RATE = 600, 44100
STFT_SHAPES = ((1024, 256), (8192, 2048))  # (frame_length, hop): the CLI default, and past JAX's 4096 gate
REPLACES = {
    "collapse": "configurable_spectrograms_tpu/ops/pallas_kernels.py:32",
    "fused_quantize": "configurable_spectrograms_tpu/ops/pallas_kernels.py:44",
    "stft_power": "configurable_spectrograms_tpu/ops/pallas_kernels.py:244",
}
SOURCES = {
    "collapse": "configurable_spectrograms_torch/csrc/collapse.cu",
    "fused_quantize": "configurable_spectrograms_torch/csrc/fused_quantize.cu",
    "stft_power": "configurable_spectrograms_torch/csrc/stft_power.cu",
}
H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's data sheet (SXM, 700 W)
H100_TF32_FLOPS = 495e12  # dense TF32 tensor cores, NVIDIA's data sheet (SXM, 700 W)
STFT_EXTRA_SECONDS = 30  # audio for the odd shapes of the stft_power check
STFT_EXTRA_SHAPES = ((1000, 250), (1000, 200))  # hop % 4 != 0 (4-byte copies); L % 16 != 0 (an L tail)


def bound(nbytes: float, flop: float = 0.0, flops: float = H100_TF32_FLOPS) -> tuple[float, str]:
    """(least ms on the card, "bytes" or "operations"): the larger of bytes / HBM rate and FLOP / peak."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flop / flops * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def require(ok: bool, message: str) -> None:
    """Fail the run (a plain ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise AssertionError(message)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3, window: int = 4) -> float:
    """Milliseconds of one ``fn()`` on the current stream: CUDA events around *window*
    back-to-back calls, the median over ``reps // window`` windows, after warm-up.

    Where a call's host work (the Python wrapper, the launch) takes longer than
    its device work, this measures the host: that is what a caller waits for.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(1, reps // window)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(window):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / window)
    return float(np.median(times))


def kernel_inputs(T: int, A: int, E: int, seed: int):
    """One cube and 8 lanes (4 pitch masks x full/zoom windows), as a render bucket."""
    rng = np.random.default_rng(seed)
    cube = (rng.random((T, A, E), dtype=np.float32) * 50.0).astype(np.float32)
    cube[rng.random(cube.shape) < 0.02] = np.nan
    cube[rng.random(cube.shape) < 0.0005] = np.inf
    cube[rng.random(cube.shape) < 0.0005] = -np.inf
    cube[rng.random(cube.shape) < 0.01] = 0.0
    L = 8
    masks = np.zeros((L, A), bool)
    pitch = np.linspace(0.0, 360.0, A, endpoint=False)
    cats = [(pitch <= 30) | (pitch >= 330), (pitch >= 150) & (pitch <= 210),
            ((pitch >= 40) & (pitch <= 140)) | ((pitch >= 210) & (pitch <= 330)), np.ones(A, bool)]
    t_valid = T - 37
    t_start = np.zeros(L, np.int32)
    t_count = np.full(L, t_valid, np.int32)
    for j in range(L):
        masks[j] = cats[j % 4]
        if j >= 4:  # zoom column: an interior window
            t_start[j], t_count[j] = T // 3, T // 4
    e_valid = np.ones((L, E), bool)
    e_valid[:, : E // 6] = False  # energies above the y range
    return {
        "cube": cube[None], "u_idx": np.zeros(L, np.int32), "masks": masks,
        "t_valid": np.full(L, t_valid, np.int32), "t_start": t_start, "t_count": t_count,
        "e_valid": e_valid,
    }


def lane_bytes(K, cubes, u_idx, masks, t_valid) -> tuple[int, int, int]:
    """(bytes a lane layout must read, bytes the grouped collapse reads, its number of lane groups).

    A lane needs the (t, a) rows of its cube at its selected bins below its
    t_valid.  The least read is each used cube's needed rows once; the
    collapse kernels read each lane group's needed rows once
    (``kernels.lane_groups`` states the grouping).
    """
    _, T, A, E = cubes.shape
    u = u_idx.cpu().numpy()
    m = masks.cpu().numpy()
    tv = t_valid.cpu().numpy()

    def slices(lanes) -> int:
        return E * 4 * int(np.clip(tv[lanes], 0, T).max()) * int(m[lanes].any(axis=0).sum())

    need = sum(slices(np.flatnonzero(u == c)) for c in np.unique(u))
    groups = K.lane_groups(u_idx)
    return need, sum(slices(np.array(g)) for g in groups), len(groups)


def collapse_case(K, name: str, cubes, u_idx, masks, t_valid, library=None) -> dict:
    """One collapse layout: bit-exact against the plain version, timed, with its bound.

    *library*, where given, is one PyTorch call computing the same sums
    (``torch.nansum`` over pitch), timed beside the kernel.
    """
    import torch

    args = (cubes, u_idx, masks, t_valid)
    got = K.collapse_lanes(*args)
    want = K.collapse_lanes_plain(*args)
    torch.cuda.synchronize()
    nan_same = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    fin = ~torch.isnan(want)
    exact = bool(torch.equal(got[fin], want[fin]))
    diff = (got[fin] - want[fin]).abs()
    diff = torch.where(torch.isnan(diff), torch.zeros_like(diff), diff)  # inf - inf
    err = float(diff.max()) if diff.numel() else 0.0
    del got, want, fin, diff
    ms = cuda_time_ms(lambda: K.collapse_lanes(*args))
    plain_ms = cuda_time_ms(lambda: K.collapse_lanes_plain(*args), reps=10)
    library_ms = cuda_time_ms(library) if library is not None else None
    _, T, A, E = cubes.shape
    L = int(u_idx.shape[0])
    need, read, groups = lane_bytes(K, cubes, u_idx, masks, t_valid)
    out_bytes = L * T * E * 4
    # Least bytes: each used cube's needed rows once, each lane's (T, E) written once.
    bound_ms, bound_by = bound(need + out_bytes)
    say("kernel", name="collapse", case=name, shape=f"{T}x{A}x{E}", cubes=len(torch.unique(u_idx)), lanes=L,
        groups=groups, exact=exact, nan_same=nan_same, max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=None if library_ms is None else f"{library_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, bound_share=f"{bound_ms / ms:.3f}",
        read_GBps=f"{(read + out_bytes) / ms / 1e6:.1f}")
    require(exact and nan_same, f"collapse kernel differs from its plain version: {name} at {T}x{A}x{E}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_collapse_layouts(K, device) -> None:
    """The lane layouts besides one bucket on one cube: two cubes, more lanes than a group, extrema."""
    import torch

    T, A, E = SHAPES[1]
    x = kernel_inputs(T, A, E, seed=2)
    cube = torch.from_numpy(x["cube"][0]).to(device)
    masks = torch.from_numpy(x["masks"]).to(device)
    two = torch.stack([cube, cube.flip(0) * 1.5])
    u = torch.tensor([0, 1, 0, 1, 1, 0, 1, 0], dtype=torch.int32, device=device)
    tv = torch.tensor([T, T - 5, T - 37, T, 1, T, T - 100, 7], dtype=torch.int32, device=device)
    collapse_case(K, "two_cubes_interleaved", two, u, masks, tv)
    n = K.COLLAPSE_GROUP + 3
    many = torch.cat([masks, masks[:3].flip(1)])
    tv = torch.arange(T, T - n, -1, dtype=torch.int32, device=device)
    collapse_case(K, f"{n}_lanes_one_cube", cube[None], torch.zeros(n, dtype=torch.int32, device=device), many, tv)

    # The extrema pre-pass: one all-pitch lane per cube, at the real cube size.
    T, A, E = SHAPES[0]
    big = torch.from_numpy(kernel_inputs(T, A, E, seed=3)["cube"][0]).to(device)
    cubes = torch.stack([big, big.flip(0), big * 1.5, big.roll(7, dims=2)])
    del big
    tv = torch.tensor([T, T - 37, T - T // 8, 1], dtype=torch.int32, device=device)
    collapse_case(K, "extrema_4_cubes", cubes, torch.arange(4, dtype=torch.int32, device=device),
                  torch.ones((4, A), dtype=torch.bool, device=device), tv,
                  library=lambda: torch.nansum(cubes, dim=2))


def fused_case(K, name: str, fargs: tuple, z_scale: str) -> dict:
    """One fused layout in one z scale: held to its contract against the plain version, timed, with its bound.

    The contract: vmin and col_all_nan bit-exact, idx within one bin, and
    every cell one bin apart on a provable bin boundary (the two float32
    log10s, log10f and torch's, may round apart there).
    """
    import torch

    cubes, u_idx, masks, e_valid, t_valid = fargs[:5]
    zb = fargs[7]
    _, T, A, E = cubes.shape
    L = int(u_idx.shape[0])
    got = K.fused_quantize_lanes(*fargs, z_scale=z_scale)
    want = K.fused_quantize_lanes_plain(*fargs, z_scale=z_scale)
    torch.cuda.synchronize()
    d = (got["idx"].int() - want["idx"].int()).abs()
    n_diff = int((d > 0).sum())
    max_bin = int(d.max())
    vmin_ok = bool(torch.equal(got["vmin"], want["vmin"]))
    nan_ok = bool(torch.equal(got["col_all_nan"], want["col_all_nan"]))
    n_boundary = 0
    lanes_off = torch.nonzero((d > 0).any(dim=2).any(dim=1)).flatten().tolist()
    if lanes_off:
        collapsed = K.collapse_lanes_plain(cubes, u_idx, masks, t_valid)
        for j in lanes_off:
            n_boundary += int(boundary_mask(collapsed[j].cpu().numpy(), float(want["vmin"][j]), float(zb[j, 1]),
                                            z_scale, (d[j] > 0).cpu().numpy()).sum())
        del collapsed
    floored = int((want["vmin"] == 1e-10).sum()) if z_scale == "log" else 0
    del got, want, d
    ms = cuda_time_ms(lambda: K.fused_quantize_lanes(*fargs, z_scale=z_scale))
    plain_ms = cuda_time_ms(lambda: K.fused_quantize_lanes_plain(*fargs, z_scale=z_scale), reps=10)
    need, read, groups = lane_bytes(K, cubes, u_idx, masks, t_valid)
    # Least bytes: each used cube's needed rows once, the uint8 indices once.
    bound_ms, bound_by = bound(need + L * T * E)
    # What this design moves: each group's needed rows once, the float32
    # scratch written and read back, the uint8 indices written.
    moved = read + L * T * E * (4 + 4 + 1)
    say("kernel", name="fused_quantize", case=name, z=z_scale, shape=f"{T}x{A}x{E}",
        cubes=len(torch.unique(u_idx)), lanes=L, groups=groups, lanes_floored=floored,
        cells_off_by_one=n_diff, of_them_on_a_bin_boundary=n_boundary, max_bin_diff=max_bin,
        vmin_exact=vmin_ok, col_all_nan_exact=nan_ok, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=None, bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, bound_share=f"{bound_ms / ms:.3f}",
        read_GBps=f"{moved / ms / 1e6:.1f}", hbm_share=f"{moved / (ms * 1e-3) / H100_BYTES_PER_S:.3f}")
    require(max_bin <= 1 and n_boundary == n_diff and vmin_ok and nan_ok,
            f"fused kernel outside its contract: {name} at {T}x{A}x{E} z={z_scale}")
    return {"max_abs_err": float(max_bin), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def fused_phases(K, fargs: tuple, z_scale: str) -> None:
    """Time the fused kernel's two launches apart: does launch 2 find the scratch in L2?

    Launch 2 alone back to back reads a scratch that the previous call left
    in L2 (warm); after a 256 MB write it reads it from HBM (cold).  Where
    the two differ, the whole call minus launch 1 tells which it found;
    where they are equal, launch 2 does not wait on its re-read.
    """
    import torch

    cubes, u_idx = fargs[:2]
    _, T, A, E = cubes.shape
    L = int(u_idx.shape[0])
    work, out = K.fused_buffers(L, T, E, cubes.device)

    def run(phases):
        return lambda: K.fused_launch(fargs, z_scale, work, out, phases)

    both = cuda_time_ms(run(K.FUSED_BOTH))
    stats = cuda_time_ms(run(K.FUSED_STATS))
    warm = cuda_time_ms(run(K.FUSED_MAP))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=cubes.device)
    cold = []
    for _ in range(5):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(K.FUSED_MAP)()
        end.record()
        end.synchronize()
        cold.append(start.elapsed_time(end))
    del flush, work, out
    say("kernel", name="fused_quantize", case="launches_apart", z=z_scale, shape=f"{T}x{A}x{E}", lanes=L,
        both_ms=f"{both:.4f}", stats_ms=f"{stats:.4f}", map_l2_warm_ms=f"{warm:.4f}",
        map_cold_ms=f"{float(np.median(cold)):.4f}", both_minus_stats_ms=f"{both - stats:.4f}")


def fused_layouts(x: dict, device) -> list[tuple[str, tuple]]:
    """The fused kernel's lane layouts on one bucket's inputs, as (name, fused_quantize_lanes args).

    The bucket itself (8 lanes, one cube); two cubes with interleaved lanes;
    11 lanes on one cube (two groups); and the bucket with lanes whose
    window holds no finite positive value (an empty window, no valid
    energy, no pitch bin: with vmin 1e-12 the 1e-10 floor shows in log z),
    beside a lane with no file rows (all NaN).
    """
    import torch

    T = x["cube"].shape[1]
    zb = np.tile(np.array([[2.0, 900.0]], np.float32), (8, 1))
    zb[1] = (0.5, 40.0)

    def dev(**a):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in a.items()}

    def args(d):
        return (d["cube"], d["u_idx"], d["masks"], d["e_valid"], d["t_valid"], d["t_start"], d["t_count"], d["zb"])

    out = [("bucket_8_lanes", args(dev(**x, zb=zb)))]
    two = dev(**{**x, "cube": np.concatenate([x["cube"], x["cube"][:, ::-1] * np.float32(1.5)]), "zb": zb,
                 "u_idx": np.array([0, 1, 0, 1, 1, 0, 1, 0], np.int32),
                 "t_valid": np.array([T, T - 5, T - 37, T, 1, T, T - 100, 7], np.int32)})
    out.append(("two_cubes_interleaved", args(two)))
    n = 11
    pick = list(range(8)) + [0, 1, 2]
    many = dev(cube=x["cube"], u_idx=np.zeros(n, np.int32),
               masks=np.concatenate([x["masks"], x["masks"][:3, ::-1]]), e_valid=x["e_valid"][pick],
               t_valid=np.arange(T, T - n, -1, dtype=np.int32), t_start=x["t_start"][pick],
               t_count=x["t_count"][pick], zb=zb[pick])
    out.append((f"{n}_lanes_one_cube", args(many)))
    none = {k: v.copy() for k, v in x.items() if k != "cube"}
    zb_none = zb.copy()
    zb_none[:3, 0] = 1e-12
    none["t_count"][0] = 0  # an empty window
    none["e_valid"][1] = False  # no valid energy
    none["masks"][2] = False  # no pitch bin: every sum is +0.0
    none["t_valid"][5] = 0  # no file rows: every cell NaN, every column all-NaN
    out.append(("no_positive_value", args(dev(cube=x["cube"], **none, zb=zb_none))))
    return out


def check_kernels(device) -> dict:
    """Kernel vs plain on the card at each shape; returns the record per kernel."""
    import torch

    from configurable_spectrograms_torch.ops import kernels as K

    records = {}
    for si, (T, A, E) in enumerate(SHAPES):
        x = kernel_inputs(T, A, E, seed=si)
        layouts = fused_layouts(x, device)
        bucket = layouts[0][1]
        rec = collapse_case(K, "bucket_8_lanes", bucket[0], bucket[1], bucket[2], bucket[4])
        if si == 0:
            records["collapse"] = rec
        for name, fargs in layouts:
            for z_scale in ("log", "linear"):
                rec = fused_case(K, name, fargs, z_scale)
                if si == 0 and z_scale == "log" and name == "bucket_8_lanes":
                    records["fused_quantize"] = rec
        for z_scale in ("log", "linear"):
            fused_phases(K, bucket, z_scale)
        del x, layouts, bucket
    check_collapse_layouts(K, device)
    return records


GOLDEN_PITCH_GRID = "tests/goldens/fast_pitch_grid_200dpi.png"
FONT_DIFF_LIMIT = 0.02  # share of the canvas; PIL's 10-px default font differed in 25.9%


def run_font_and_png() -> None:
    """[font]: the golden pitch grid on the host backend against its golden.  [png]: that canvas, native vs PIL.

    The inputs are those of tests/test_golden_figures.py:54-80.  The render
    must use a real font file (the port's bundled DejaVuSans.ttf) and differ
    from the golden in at most FONT_DIFF_LIMIT of the canvas (what is left
    is FreeType's version).  Then the 4800x2400 RGBA canvas is encoded by
    the native encoder and by PIL at compress_level=3 (the port's encode
    before the native one: ``convert("RGB")`` and ``save``); the two files
    must decode to the same pixels.
    """
    from PIL import Image

    from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive
    from configurable_spectrograms_torch.fast.plotting import FAST_plot_pitch_angle_grid
    from configurable_spectrograms_torch.render import fastpng, text

    here = os.path.dirname(os.path.abspath(__file__))
    font = text._font_path()
    with tempfile.TemporaryDirectory(prefix="cst_chip_font_") as tmp:
        mapping = synth_fast_archive(tmp, [4242], n_time=120, n_angle=12, n_energy=24,
                                     cusp_csv_path=os.path.join(tmp, "cusp.tsv"), seed=7)
        os.environ["CST_RENDER_BACKEND"] = "host"
        fig, _ = FAST_plot_pitch_angle_grid(
            mapping[4242]["ees"], filtered_orbits_df=load_filtered_orbits(os.path.join(tmp, "cusp.tsv")),
            orbit_number=4242, scale_function_y="log", scale_function_z="log", show=False, colormap="inferno")
        image = fig.render(dpi=200)
        os.environ.pop("CST_RENDER_BACKEND", None)
        canvas = image._np_canvas
        golden = np.asarray(Image.open(os.path.join(here, GOLDEN_PITCH_GRID)).convert("RGB"))
        require(canvas.shape[:2] == golden.shape[:2], f"pitch grid {canvas.shape} vs golden {golden.shape}")
        n_diff = int((canvas[..., :3] != golden).any(axis=-1).sum())
        share = n_diff / (golden.shape[0] * golden.shape[1])
        say("font", path=None if font is None else os.path.relpath(font, here), bundled=font == text.BUNDLED_FONT,
            golden=GOLDEN_PITCH_GRID, canvas=f"{golden.shape[1]}x{golden.shape[0]}", pixels_differ=n_diff,
            share=f"{share:.6f}", limit=FONT_DIFF_LIMIT)
        require(font is not None and os.path.isfile(font), f"no font file at {font}")
        require(share <= FONT_DIFF_LIMIT, f"the pitch grid differs from its golden in {share:.2%} of the canvas")

        t0 = time.perf_counter()
        fastpng.library()
        build_s = time.perf_counter() - t0
        native_path, pil_path = os.path.join(tmp, "native.png"), os.path.join(tmp, "pil.png")
        native_ms, pil_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            fastpng.write_png_rgb(canvas, native_path, 3)
            native_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(3):
            t0 = time.perf_counter()
            image.convert("RGB").save(pil_path, format="PNG", compress_level=3)
            pil_ms.append((time.perf_counter() - t0) * 1e3)
        with Image.open(native_path) as a, Image.open(pil_path) as b:
            same = np.array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))
            same = same and np.array_equal(np.asarray(a.convert("RGB")), canvas[..., :3])
        say("png", library=os.path.relpath(str(fastpng.BUILD_INFO["path"]), here), variant=fastpng.BUILD_INFO["variant"],
            build_s=f"{build_s:.2f}", blend=fastpng.blend_route(), canvas=f"{canvas.shape[1]}x{canvas.shape[0]}",
            native_ms=f"{float(np.median(native_ms)):.2f}", pil_ms=f"{float(np.median(pil_ms)):.2f}",
            native_bytes=os.path.getsize(native_path), pil_bytes=os.path.getsize(pil_path),
            decoded_identical=same)
        require(same, "the native and PIL PNGs decode to different pixels")


def orbit_figures(paths: dict, df, orbit: int, extrema: dict | None) -> list:
    """Every figure FAST_process_single_orbit renders for one log/log orbit."""
    from configurable_spectrograms_torch.fast.constants import DEFAULT_INSTRUMENT_ORDER
    from configurable_spectrograms_torch.fast.extrema import extrema_overrides
    from configurable_spectrograms_torch.fast.plotting import (
        FAST_plot_instrument_grid,
        FAST_plot_pitch_angle_grid,
    )

    figs = []
    for inst in DEFAULT_INSTRUMENT_ORDER:
        for ymn, ymx, zmn, zmx in (extrema_overrides(extrema, inst, "log", "log"), (None,) * 4):
            fig, _ = FAST_plot_pitch_angle_grid(
                paths[inst], filtered_orbits_df=df, orbit_number=orbit, scale_function_y="log",
                scale_function_z="log", show=False, colormap="inferno",
                y_min=ymn, y_max=ymx, z_min=zmn, z_max=zmx)
            figs.append(fig)
    for ex in (extrema, None):
        fig, _ = FAST_plot_instrument_grid(
            paths, filtered_orbits_df=df, orbit_number=orbit, scale_function_y="log",
            scale_function_z="log", show=False, colormap="inferno", global_extrema=ex)
        figs.append(fig)
    return figs


def figure_panels(figs: list, dpi: float | None = None) -> list:
    """The (tile_h, tile_w, panel) of every panel of *figs* at *dpi* (default: the FAST save DPI)."""
    from configurable_spectrograms_torch.constants import FAST_SAVE_DPI
    from configurable_spectrograms_torch.render.compositor import _Layout

    out = []
    for fig in figs:
        lay = _Layout(fig, float(dpi or FAST_SAVE_DPI))
        out += [(lay.tile_h, lay.tile_w, ax.panel) for ax in fig.axes if ax.panel is not None]
    return out


def render_all(panels: list) -> list:
    from configurable_spectrograms_torch.render.dispatch import render_panels

    by_tile: dict = {}
    for k, (h, w, p) in enumerate(panels):
        by_tile.setdefault((h, w), []).append(k)
    results = [None] * len(panels)
    for (h, w), ks in by_tile.items():
        for k, r in zip(ks, render_panels([panels[k][2] for k in ks], h, w)):
            results[k] = r
    return results


def boundary_mask(m: np.ndarray, vmin: float, vmax: float, z_scale: str, off: np.ndarray) -> np.ndarray:
    """The ``off`` cells of the collapsed matrix *m* that provably sit on a bin boundary.

    Recomputes the normalisation in float64 (the check of
    tests/test_fuzz_parity.py): a cell counts when norm * 256 lies within a
    few float32 ulps of an integer, where two float32 log10s, or a float32
    against a float64 span, can round to neighbouring bins.
    """
    if not off.any():
        return off
    m = m.astype(np.float64)
    if z_scale == "log":
        lmin, lmax = np.log10(vmin), np.log10(vmax)
        lw = np.log10(np.maximum(np.where(~np.isfinite(m) | (m <= 0), vmin, m), 1e-37))
        bins = (lw - lmin) / (lmax - lmin) * 256.0
        big = max(abs(lmin), abs(lmax), float(np.abs(lw[off]).max()))
        tol = 256.0 * 6.0 * float(np.spacing(np.float32(big))) / (lmax - lmin)
    else:
        w = np.where(np.isposinf(m), vmax, np.where(np.isnan(m) | np.isneginf(m), vmin, m))
        bins = (w - vmin) / (vmax - vmin) * 256.0
        tol = max(1e-4, float(np.abs(bins[off]).max()) * 6.0e-7)
    return (np.abs(bins - np.rint(bins)) <= tol) & off


def compare_panels(panels: list, dev: list, host: list) -> tuple[int, int, int]:
    """Device vs host: bounds bit for bit, index cells within one bin.

    The index map is elementwise over the whole (T, E) matrix, so every
    row the device brought back (all of them, or the rows the pixels
    sample) is compared over the file's E columns.  A cell one bin apart
    must sit on a bin boundary.  Returns (cells compared, cells one bin
    apart, of those the cells on a bin boundary).
    """
    from configurable_spectrograms_torch.render.host_quantize import host_collapse

    n_cells = n_off = n_boundary = 0
    for (_, _, p), d, h in zip(panels, dev, host):
        if "error" in h or "error" in d:
            require(d.get("error") == h.get("error"), f"panel error: {d.get('error')!r} vs {h.get('error')!r}")
            continue
        for k in ("vmin", "vmax", "y0", "y1", "n_kept", "empty"):
            # The device holds bounds in float32; the host's explicit bounds
            # are the same values as Python floats.
            a, b = np.float32(d[k]), np.float32(h[k])
            require(np.array_equal(a, b, equal_nan=True), f"panel {k}: device {a!r} vs host {b!r}")
        if h["empty"]:
            continue
        T, _, E = p.cube.shape
        rows = d["idx_rows"][: d["idx"].shape[0]]
        keep = rows < T
        dv = d["idx"][keep][:, :E].astype(np.int32)
        hv = h["idx"][rows[keep]].astype(np.int32)
        diff = np.abs(dv - hv)
        require(diff.size == 0 or int(diff.max()) <= 1, f"idx differs by {int(diff.max())} bins")
        n_cells += diff.size
        n_off += int((diff > 0).sum())
        if (diff > 0).any():
            m = host_collapse(p.cube, p.pitch_mask)[rows[keep]]
            n_boundary += int(boundary_mask(m, float(h["vmin"]), float(h["vmax"]), p.z_scale, diff > 0).sum())
    require(n_boundary == n_off, f"{n_off - n_boundary} of {n_off} index cells differ away from a bin boundary")
    return n_cells, n_off, n_boundary


def make_archive(tmp: str, small=SHAPES[1], big=SHAPES[0]) -> tuple[str, dict]:
    """The synthetic archive under *tmp*/data: orbits 100-102 at *small*, 103 at *big*, one cusp table *tmp*/cusp.tsv."""
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    mapping = synth_fast_archive(root, [100, 101, 102], n_time=small[0], n_angle=small[1],
                                 n_energy=small[2], cusp_csv_path=os.path.join(tmp, "cusp.tsv"))
    mapping.update(synth_fast_archive(root, [103], n_time=big[0], n_angle=big[1], n_energy=big[2],
                                      compress="none", cusp_csv_path=os.path.join(tmp, "cusp_big.tsv")))
    # One cusp table for all four orbits.
    with open(os.path.join(tmp, "cusp.tsv")) as a, open(os.path.join(tmp, "cusp_big.tsv")) as b:
        rows = a.read().rstrip("\n").splitlines() + b.read().rstrip("\n").splitlines()[1:]
    with open(os.path.join(tmp, "cusp.tsv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    say("e2e", step="synth_archive", seconds=f"{time.perf_counter() - t0:.2f}",
        orbits=f"100-102@{'x'.join(map(str, small))},103@{'x'.join(map(str, big))}", instruments=4)
    return root, mapping


def run_e2e(records: dict, small=SHAPES[1], big=SHAPES[0]) -> None:
    import torch

    from configurable_spectrograms_torch.constants import FAST_SAVE_DPI
    from configurable_spectrograms_torch.data.cdf_utils import (
        clear_dataset_cache,
        load_fast_cdf_dataset,
        load_filtered_orbits,
    )
    from configurable_spectrograms_torch.fast.constants import DEFAULT_INSTRUMENT_ORDER
    from configurable_spectrograms_torch.fast.extrema import compute_global_extrema
    from configurable_spectrograms_torch.fast.process_orbit import FAST_process_single_orbit
    from configurable_spectrograms_torch.ops import kernels as K
    from configurable_spectrograms_torch.render.device_cache import upload_telemetry

    try:
        import PIL  # noqa: F401

        have_pil = True
    except ImportError as exc:
        have_pil = False
        say("e2e", composite_and_png="not run", why=f"PIL does not import ({exc})")

    with tempfile.TemporaryDirectory(prefix="cst_chip_smoke_") as tmp:
        root, mapping = make_archive(tmp, small, big)
        df = load_filtered_orbits(os.path.join(tmp, "cusp.tsv"))

        extrema = {}
        render_s = {}
        for backend in ("device", "host"):
            os.environ["CST_RENDER_BACKEND"] = backend
            clear_dataset_cache()  # each backend decodes the archive itself
            t0 = time.perf_counter()
            for paths in mapping.values():
                for path in paths.values():
                    load_fast_cdf_dataset(path)
            say("e2e", backend=backend, decode_s=f"{time.perf_counter() - t0:.2f}", files=4 * len(mapping))
            out_dir = os.path.join(tmp, f"plots_{backend}")
            if backend == "device":
                K.reset_launches()
            t0 = time.perf_counter()
            extrema[backend] = compute_global_extrema(
                root, "log", "log", DEFAULT_INSTRUMENT_ORDER,
                extrema_json_path=os.path.join(tmp, f"extrema_{backend}.json"))
            torch.cuda.synchronize()
            t_extrema = time.perf_counter() - t0
            if backend == "device":
                launches_extrema = dict(K.LAUNCHES)
            if have_pil:
                t0 = time.perf_counter()
                per_orbit = []
                for orbit in sorted(mapping):
                    t1 = time.perf_counter()
                    res = FAST_process_single_orbit(
                        orbit, mapping[orbit], df, 6.25, "log", "log", DEFAULT_INSTRUMENT_ORDER,
                        "inferno", out_dir, global_extrema=extrema[backend])
                    torch.cuda.synchronize()
                    per_orbit.append(f"{orbit}:{time.perf_counter() - t1:.2f}s")
                    require(res["status"] == "ok", f"orbit {orbit}: {res}")
                t_render = render_s[backend] = time.perf_counter() - t0
                n_png = len(glob.glob(os.path.join(out_dir, "**", "*.png"), recursive=True))
                say("e2e", backend=backend, extrema_s=f"{t_extrema:.2f}", render_s=f"{t_render:.2f}",
                    pngs=n_png, per_orbit=",".join(per_orbit))
            if backend == "device":
                launches = dict(K.LAUNCHES)
                say("e2e", backend="device", launches=json.dumps(launches),
                    extrema_launches=json.dumps(launches_extrema))
                require(launches_extrema["collapse"] > 0, "the extrema pre-pass launched no collapse kernel")
                require(not have_pil or min(launches["collapse"], launches["fused_quantize"]) > 0,
                        f"a kernel of the render path never launched: {launches}")
                add_launches(records, launches)
        require(extrema["device"] == extrema["host"], "extrema JSON differs between backends")
        say("e2e", extrema_json="device == host", keys=len(extrema["device"]))

        # Panel parity, orbit by orbit: the same figures process_orbit renders
        # (a second render of each panel), then where one orbit's time goes:
        # dispatch, composite, PNG encode.
        n_panels = 0
        for orbit in sorted(mapping):
            figs = orbit_figures(mapping[orbit], df, orbit, extrema["device"])
            panels = figure_panels(figs)
            results = {}
            secs = {}
            for backend in ("device", "host"):
                os.environ["CST_RENDER_BACKEND"] = backend
                if not have_pil and backend == "device":
                    K.reset_launches()
                before = upload_telemetry()
                t0 = time.perf_counter()
                results[backend] = render_all(panels)
                torch.cuda.synchronize()
                secs[backend] = time.perf_counter() - t0
                if backend == "device":
                    tele = telemetry_since(before)
            if not have_pil:
                add_launches(records, {k: K.LAUNCHES[k] for k in ("collapse", "fused_quantize")})
                require(min(K.LAUNCHES["collapse"], K.LAUNCHES["fused_quantize"]) > 0,
                        f"a kernel of the render path never launched: {K.LAUNCHES}")
            cells, off, on_boundary = compare_panels(panels, results["device"], results["host"])
            n_panels += len(panels)
            T, A, E = panels[0][2].cube.shape
            say("e2e", orbit=orbit, shape=f"{T}x{A}x{E}", panels=len(panels), cells=cells,
                cells_one_bin_apart=off, of_them_on_a_bin_boundary=on_boundary, bounds="bit-exact")
            if have_pil:
                # The second device render of the same figures: the cubes are resident now.
                os.environ["CST_RENDER_BACKEND"] = "device"
                second = render_and_save(figs, FAST_SAVE_DPI, os.path.join(tmp, f"breakdown_{orbit}"))
                cube_bytes = len({id(p.cube) for _, _, p in panels}) * padded_cube_bytes(panels[0][2].cube)
                say("breakdown", orbit=orbit, shape=f"{T}x{A}x{E}", figures=len(figs),
                    dispatch_s=f"{secs['device']:.3f}", composite_s=f"{second['composite_s']:.3f}",
                    render_minus_dispatch_s=f"{second['render_s'] - secs['device']:.3f}",
                    png_s=f"{second['png_s']:.3f}", host_dispatch_warm_s=f"{secs['host']:.3f}",
                    h2d_bytes=tele["upload_bytes"], cube_hits=tele["cube_hits"], cube_misses=tele["cube_misses"],
                    second_render_s=f"{second['render_s']:.3f}", second_h2d_bytes=second["h2d_bytes"],
                    second_cube_hits=second["cube_hits"], second_cube_misses=second["cube_misses"],
                    orbit_padded_cube_bytes=cube_bytes)
                require(second["h2d_bytes"] <= cube_bytes,
                        f"orbit {orbit}: the second render shipped {second['h2d_bytes']} bytes, more than one padded "
                        f"copy of its cubes ({cube_bytes})")
        for backend, secs_b in render_s.items():
            say("e2e", backend=backend, orbits=len(mapping), panels=n_panels,
                panels_per_s=f"{n_panels / secs_b:.2f}", note="process_orbit incl. decode, composite, PNG")
        require(have_pil, "PIL does not import: the batch phase writes PNGs")
        run_generic(records, mapping, tmp)
        runs = run_batch(records, mapping, root, os.path.join(tmp, "cusp.tsv"), tmp)
        os.environ.pop("CST_RENDER_BACKEND", None)
        run_gui(records, mapping, root, os.path.join(tmp, "cusp.tsv"), tmp, runs["device"])
        run_parallel(records, mapping, root, os.path.join(tmp, "cusp.tsv"), tmp, runs["device"])


def add_launches(records: dict, counts: dict) -> None:
    """Add one phase's launch counts to the kernels' records."""
    for name, n in counts.items():
        if name in records:
            records[name]["launches"] = records[name].get("launches", 0) + n


def telemetry_since(before: dict) -> dict:
    """What ``render.device_cache.upload_telemetry()`` counted since *before*."""
    from configurable_spectrograms_torch.render.device_cache import upload_telemetry

    after = upload_telemetry()
    return {k: after[k] - before[k] for k in after}


def padded_cube_bytes(cube: np.ndarray) -> int:
    """Bytes of one padded device copy of *cube* (the dispatch's bucket shape)."""
    from configurable_spectrograms_torch.render.dispatch import _bucket

    T, A, E = cube.shape
    return _bucket(T, 256, 64) * _bucket(A, 8, 8) * _bucket(E, 8, 8) * 4


def render_and_save(figs: list, dpi: float, prefix: str) -> dict:
    """Render *figs* and save each PNG: seconds of the render, of its composite stage and of the encodes, and the upload telemetry."""
    import torch

    from configurable_spectrograms_torch.render.figure import render_figures, save_image
    from configurable_spectrograms_torch.render.device_cache import upload_telemetry
    from configurable_spectrograms_torch.utils import timing

    before = upload_telemetry()
    timer = timing.ACTIVE = timing.StageTimer("chip_smoke")
    try:
        t0 = time.perf_counter()
        images = render_figures(figs, dpi=dpi)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for k, img in enumerate(images):
            save_image(img, f"{prefix}_{k}.png")
        t2 = time.perf_counter()
    finally:
        timing.ACTIVE = None
    tele = telemetry_since(before)
    return {"render_s": t1 - t0, "composite_s": timer.totals.get("composite", 0.0), "png_s": t2 - t1,
            "h2d_bytes": tele["upload_bytes"], "cube_hits": tele["cube_hits"], "cube_misses": tele["cube_misses"]}


def stft_tolerance(ref, got) -> tuple[float, float]:
    """(max |got - ref|, max of |got - ref| / (1e-4 * max(|ref|, 1e-3 * max|ref|) + 1e-2)).

    The bound of tests/test_stft.py:243-244; a ratio <= 1 passes.
    """
    import torch

    ref = torch.as_tensor(ref, dtype=torch.float32)
    got = torch.as_tensor(got, dtype=torch.float32).to(ref.device)
    diff = (got - ref).abs()
    scale = torch.maximum(ref.abs(), 1e-3 * ref.abs().max())
    return float(diff.max()), float((diff / (1e-4 * scale + 1e-2)).max())


def make_audio(seconds: float, rate: int, seed: int = 0) -> np.ndarray:
    """Seeded 16-bit mono audio: a 50 Hz - 15 kHz exponential chirp, 440 Hz and 6 kHz tones, noise at -30 dB."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n, dtype=np.float64) / rate
    k = np.log(15000.0 / 50.0)
    x = 0.3 * np.sin(2.0 * np.pi * 50.0 * seconds / k * np.expm1(k * t / seconds))
    x += 0.2 * np.sin(2.0 * np.pi * 440.0 * t) + 0.2 * np.sin(2.0 * np.pi * 6000.0 * t)
    x += 0.3 * 10.0 ** (-30.0 / 20.0) * rng.standard_normal(n)
    return np.round(x * 32767.0).astype(np.int16)


def stft_case(K, x, L: int, hop: int, f64: bool = False) -> dict:
    """stft_power against its plain version on one (L, hop), timed, with its bound and cuBLAS beside it.

    With *f64*, also the largest error of the kernel and of the plain
    version against float64 products of the same frames and bases: the
    kernel's must be within 4x the plain version's (3xTF32 keeps fp32
    quality, not only the tolerance).
    """
    import torch

    from configurable_spectrograms_torch.ops.stft import _dft_bases, frame_signal

    frames = frame_signal(x, L, hop)
    cos_b, sin_b = (torch.from_numpy(b).to(x.device) for b in _dft_bases(L))
    F, K_bins = frames.shape[0], cos_b.shape[1]
    got = K.stft_power(frames, cos_b, sin_b)
    want = K.stft_power_plain(frames, cos_b, sin_b)
    torch.cuda.synchronize()
    err, ratio = stft_tolerance(want, got)
    f64_fields = {}
    if f64:
        fd = frames.double()
        ref = (fd @ cos_b.double()).square_() + (fd @ sin_b.double()).square_()
        del fd
        err_k = float((got.double() - ref).abs().max())
        err_p = float((want.double() - ref).abs().max())
        del ref
        f64_fields = {"f64_err_kernel": err_k, "f64_err_plain": err_p, "f64_err_ratio": f"{err_k / err_p:.3f}"}
    del got, want
    ms = cuda_time_ms(lambda: K.stft_power(frames, cos_b, sin_b))
    plain_ms = cuda_time_ms(lambda: K.stft_power_plain(frames, cos_b, sin_b), reps=10)
    prep_ms = cuda_time_ms(lambda: K.stft_bases_t(cos_b, sin_b))
    fc = frames.contiguous()  # the yardstick is cuBLAS itself, not the copy of the frames

    def library():
        re = fc @ cos_b
        im = fc @ sin_b
        return re * re + im * im

    library_ms = cuda_time_ms(library)
    del fc
    flop = 4.0 * F * K_bins * L  # two products, one FMA = 2 FLOP
    # Least bytes: the signal the frames span, both bases, the output; 3 TF32 products a product.
    nbytes = 4.0 * ((F - 1) * hop + L + 2 * L * K_bins + F * K_bins)
    bound_ms, bound_by = bound(nbytes, 3.0 * flop)
    staging = "cp.async16" if hop % 4 == 0 and L % 4 == 0 else "cp.async4"
    say("kernel", name="stft_power", F=F, L=L, hop=hop, K=K_bins, staging=staging, max_abs_err=err,
        tol_ratio=f"{ratio:.3e}", **f64_fields, ms=f"{ms:.4f}", bases_prep_ms=f"{prep_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, bound_share=f"{bound_ms / ms:.3f}", gflop=f"{flop / 1e9:.1f}",
        GFLOPs=f"{flop / ms / 1e6:.1f}", tf32_GFLOPs=f"{3 * flop / ms / 1e6:.1f}")
    require(ratio <= 1.0, f"stft_power outside its tolerance at F={F} L={L} hop={hop}: ratio {ratio}")
    if f64:
        require(err_k <= 4.0 * err_p, f"stft_power float64 error {err_k} above 4x the plain version's {err_p}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_stft_kernel(device, signal: np.ndarray) -> dict:
    """stft_power on the audio the main path reads, at STFT_SHAPES, and on 30 s of it at the odd shapes."""
    import torch

    from configurable_spectrograms_torch.ops import kernels as K

    x = torch.from_numpy(signal).to(device)
    records = [stft_case(K, x, L, hop, f64=(i == 0)) for i, (L, hop) in enumerate(STFT_SHAPES)]
    head = x[: STFT_EXTRA_SECONDS * AUDIO_RATE]
    for L, hop in STFT_EXTRA_SHAPES:
        stft_case(K, head, L, hop, f64=True)
    return {"stft_power": records[0]}


def call_main(main, argv: list[str]) -> int:
    """A CLI's ``main()`` with *argv*, as the shell would call it (argparse exits become codes)."""
    saved = sys.argv
    sys.argv = ["prog", *argv]
    try:
        rc = main()
    except SystemExit as exc:
        rc = exc.code
    finally:
        sys.argv = saved
    return 0 if rc is None else rc


def run_generic(records: dict, mapping: dict, tmp: str) -> None:
    """The single-CDF CLI and generic_batch_plot over the archive, on the device backend."""
    import torch

    from configurable_spectrograms_torch.cli import single_plot_spectrogram as cli_single
    from configurable_spectrograms_torch.data.cdf_utils import load_fast_cdf_dataset
    from configurable_spectrograms_torch.generic_batch import generic_batch_plot
    from configurable_spectrograms_torch.ops import kernels as K

    os.environ["CST_RENDER_BACKEND"] = "device"
    K.reset_launches()
    big = max(mapping)
    out = os.path.join(tmp, "single_generic.png")
    t0 = time.perf_counter()
    rc = call_main(cli_single.main, ["--cdf-file", mapping[big]["ees"], "--output", out,
                                     "--y-scale", "log", "--z-scale", "log", "--colormap", "inferno"])
    torch.cuda.synchronize()
    require(rc == 0 and os.path.exists(out), f"single-CDF CLI exited {rc}")
    t_single = time.perf_counter() - t0

    items = [f"{orbit}_{inst}" for orbit in sorted(mapping) for inst in sorted(mapping[orbit])]

    def build(item):
        orbit, inst = item.split("_")
        d = load_fast_cdf_dataset(mapping[int(orbit)][inst])
        return [{"x": d["times"], "y": d["energy"], "data": d["data"], "label": item}]

    out_dir = os.path.join(tmp, "generic_batch")
    t0 = time.perf_counter()
    res = generic_batch_plot(items, out_dir, build, y_scale="log", z_scale="log", colormap="inferno",
                             progress_json_path=os.path.join(tmp, "generic_progress.json"),
                             install_signal_handlers=False)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    n_png = len(glob.glob(os.path.join(out_dir, "*", "generic.png")))
    launches = dict(K.LAUNCHES)
    say("generic", single_cli_rc=rc, single_cli_s=f"{t_single:.2f}", batch_items=len(items),
        batch_ok=sum(st == "ok" for _, st in res), pngs=n_png, batch_s=f"{t_batch:.2f}",
        launches=json.dumps(launches))
    require(dict(res) == {i: "ok" for i in items} and n_png == len(items), f"generic batch: {res}")
    require(launches["collapse"] > 0, "the generic CLIs launched no collapse kernel")
    add_launches(records, launches)


PANELS_PER_FIGURE = 8  # a pitch grid: 4 categories x full/zoom; an instrument grid: 4 instruments x full/zoom
#: The render back end off: every render inline on its worker thread, every bucket uploading its cubes, no gate.
BACKEND_OFF = {"CST_RENDER_COALESCE": "0", "CST_DEVICE_CUBE_CACHE": "0", "CST_HOST_COMPUTE_GATE": "0"}


def batch_cwd(path: str, root: str, cusp: str) -> str:
    """A working directory laid out as the flagless flagship CLI reads it: ./FAST_data and ./FAST_Cusp_Indices.csv."""
    import shutil

    os.makedirs(path)
    os.symlink(root, os.path.join(path, "FAST_data"))
    shutil.copy(cusp, os.path.join(path, "FAST_Cusp_Indices.csv"))
    return path


def run_flagship(cwd: str, backend: str, workers: int | None = None) -> dict:
    """The port's flagless flagship CLI (``main()``, its defaults) in *cwd* on *backend*; what it ran and wrote.

    *workers*, where given, replaces the CLI's 4 worker threads.
    """
    import signal

    from configurable_spectrograms_torch.cli import batch_multi_plot_FAST_spectrograms as flagship
    from configurable_spectrograms_torch.data import cdf_utils
    from configurable_spectrograms_torch.fast import batch_directory
    from configurable_spectrograms_torch.utils.config import FastBatchConfig
    from configurable_spectrograms_torch.utils.logging import flush_log_buffer, set_logfile_path

    results, extrema_s = [], []

    class Recorded(FastBatchConfig):  # main() drops the driver's results; keep them
        def run(self):
            if workers is not None:
                self.max_workers = workers
            results.extend(super().run())
            return results

    def timed_extrema(*a, **k):
        t = time.perf_counter()
        try:
            return real_extrema(*a, **k)
        finally:
            extrema_s.append(time.perf_counter() - t)

    real_extrema = batch_directory.compute_global_extrema
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    os.environ["CST_RENDER_BACKEND"] = backend
    os.environ.pop("CST_BATCH_SCHEDULE", None)
    cdf_utils.clear_dataset_cache()  # each run decodes the archive itself
    cdf_utils.filtered_orbits_cache.clear()  # keyed by the cwd-relative default path
    here = os.getcwd()
    os.chdir(cwd)
    flagship.FastBatchConfig, batch_directory.compute_global_extrema = Recorded, timed_extrema
    try:
        t0 = time.perf_counter()
        rc = call_main(flagship.main, [])
        sync()
        seconds = time.perf_counter() - t0
    finally:
        flagship.FastBatchConfig, batch_directory.compute_global_extrema = FastBatchConfig, real_extrema
        flush_log_buffer()
        set_logfile_path(None)
        os.chdir(here)
        for s, h in handlers.items():  # the driver installs its interrupt escalation
            signal.signal(s, h)
    pngs = {os.path.relpath(p, cwd): os.stat(p).st_mtime_ns
            for p in glob.glob(os.path.join(cwd, "FAST_plots", "**", "*.png"), recursive=True)}
    # Under a process group of several ranks each rank keeps its own state files (``.proc{rank}``).
    with open(os.path.join(cwd, batch_directory._per_process_path("batch_multi_plot_FAST_progress.json"))) as f:
        progress = json.load(f)
    extrema_path = os.path.join(cwd, batch_directory._per_process_path("FAST_calculated_extrema.json"))
    extrema = None
    if os.path.exists(extrema_path):
        with open(extrema_path) as f:
            extrema = json.load(f)
    return {"rc": rc, "seconds": seconds, "extrema_s": sum(extrema_s), "results": results, "pngs": pngs,
            "progress": progress, "extrema": extrema}


def png_bins_apart(a_path: str, b_path: str, colormap: str) -> int:
    """Pixels that differ between two PNGs; fails unless each such pair is two adjacent colormap entries.

    The rule of tests/test_torch_slice.py:42-69: a cell on a bin boundary
    may land one bin apart between the backends (two float32 ``log10``s);
    it shows as data-tile pixels whose colours are neighbouring entries of
    the colormap.  Every other pixel must match.
    """
    from PIL import Image

    from configurable_spectrograms_torch.ops._colormap_data import colormap_lut

    a = np.asarray(Image.open(a_path).convert("RGB")).astype(np.int64)
    b = np.asarray(Image.open(b_path).convert("RGB")).astype(np.int64)
    require(a.shape == b.shape, f"{a_path}: shape {a.shape} vs {b.shape}")
    diff = (a != b).any(axis=-1)
    if not diff.any():
        return 0
    lut = colormap_lut(colormap)[:, :3].astype(np.int64)
    code = {int(c): i for i, c in enumerate(lut[:, 0] << 16 | lut[:, 1] << 8 | lut[:, 2])}
    ia = [code.get(int(c), -9) for c in (a[diff][:, 0] << 16 | a[diff][:, 1] << 8 | a[diff][:, 2])]
    ib = [code.get(int(c), -99) for c in (b[diff][:, 0] << 16 | b[diff][:, 1] << 8 | b[diff][:, 2])]
    require(all(abs(x - y) == 1 for x, y in zip(ia, ib)), f"{a_path}: pixels differ by more than one colormap bin")
    return int(diff.sum())


def run_batch(records: dict, mapping: dict, root: str, cusp: str, tmp: str) -> dict:
    """The flagless flagship batch CLI over the archive (device, resume, host, device with the back end off), then the single FAST CLI.

    Returns the three batch runs, by name.
    """
    import torch

    from configurable_spectrograms_torch.cli import single_plot_FAST_spectrograms as cli_fast
    from configurable_spectrograms_torch.ops import kernels as K
    from configurable_spectrograms_torch.render.device_cache import upload_telemetry

    n_orbits = len(mapping)
    want_pngs = n_orbits * 4 * 10  # orbits x 4 combos x (4 instruments x given/raw pitch grids + 2 grids)
    runs = {}
    # The device backend with the render back end on (the defaults), the host backend, and the device
    # backend with the coalescer, the cube cache and the compute gate off.
    for name, backend, env in (("device", "device", {}), ("host", "host", {}), ("device_backend_off", "device", BACKEND_OFF)):
        cwd = batch_cwd(os.path.join(tmp, f"batch_{name}"), root, cusp)
        K.reset_launches()
        before = upload_telemetry()
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            run = runs[name] = run_flagship(cwd, backend)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        tele = telemetry_since(before)
        launches = dict(K.LAUNCHES)
        progress = run["progress"]
        cursors = sorted(k for k in progress if k.endswith("_last_orbit"))
        flagged = {k: v for k, v in progress.items() if ("error" in k or "timed_out" in k) and v}
        panels = PANELS_PER_FIGURE * len(run["pngs"])
        say("batch", run=name, backend=backend, env=json.dumps(env).replace(" ", ""), archive_s=f"{run['seconds']:.2f}",
            pngs=len(run["pngs"]), panels_per_s=f"{panels / run['seconds']:.2f}",
            render_panels_per_s=f"{panels / (run['seconds'] - run['extrema_s']):.2f}",
            extrema_s=f"{run['extrema_s']:.2f}", results=len(run["results"]), h2d_bytes=tele["upload_bytes"],
            cube_hits=tele["cube_hits"], cube_misses=tele["cube_misses"], dispatches=tele["dispatches"],
            launches=json.dumps(launches), cursors=",".join(cursors), progress_keys=len(progress))
        require(run["rc"] == 0, f"flagship CLI ({name}) exited {run['rc']}")
        require(len(run["results"]) == n_orbits * 4 * 2 and all(r["status"] == "ok" for r in run["results"]),
                f"flagship CLI ({name}): not every result ok: {[r for r in run['results'] if r['status'] != 'ok']}")
        require(len(run["pngs"]) == want_pngs, f"flagship CLI ({name}) wrote {len(run['pngs'])} PNGs, not {want_pngs}")
        require(cursors == ["linear_linear_last_orbit", "linear_log_last_orbit", "log_linear_last_orbit",
                            "log_log_last_orbit"], f"progress cursors: {cursors}")
        require(not flagged, f"flagship CLI ({name}) recorded errors or timeouts: {flagged}")
        require(run["extrema"] is not None, f"flagship CLI ({name}) wrote no extrema JSON")
        if backend == "device":
            require(min(launches["collapse"], launches["fused_quantize"]) > 0,
                    f"the flagship batch ({name}) did not launch both kernels: {launches}")
        if name == "device":
            require(tele["cube_hits"] > 0, f"the flagship batch never reused a resident cube: {tele}")
            add_launches(records, launches)
            # Resume: the same command again adds and rewrites nothing and launches nothing.
            K.reset_launches()
            again = run_flagship(cwd, backend)
            say("batch", step="resume", resume_s=f"{again['seconds']:.2f}", pngs=len(again["pngs"]),
                results=len(again["results"]), launches=json.dumps(K.LAUNCHES))
            require(again["rc"] == 0 and again["pngs"] == run["pngs"], "the resumed batch added or rewrote PNGs")
            require(sum(K.LAUNCHES.values()) == 0, f"the resumed batch launched kernels: {K.LAUNCHES}")

    dev, host, off = runs["device"], runs["host"], runs["device_backend_off"]
    require(sorted(dev["pngs"]) == sorted(host["pngs"]), "device and host batches wrote different file lists")
    require(dev["extrema"] == host["extrema"], "extrema JSON differs between the device and host batches")
    require(sorted(dev["pngs"]) == sorted(off["pngs"]), "the batch with the back end off wrote another file list")
    require(dev["extrema"] == off["extrema"], "extrema JSON differs with the render back end off")
    say("batch", compare="back end on vs off (device)", files=len(off["pngs"]), extrema_json="identical",
        on_panels_per_s=f"{PANELS_PER_FIGURE * len(dev['pngs']) / dev['seconds']:.2f}",
        off_panels_per_s=f"{PANELS_PER_FIGURE * len(off['pngs']) / off['seconds']:.2f}",
        on_archive_s=f"{dev['seconds']:.2f}", off_archive_s=f"{off['seconds']:.2f}")
    raw = sorted(p for p in dev["pngs"] if "_raw-" in p)
    apart = same = 0
    for rel in raw:
        n = png_bins_apart(os.path.join(tmp, "batch_device", rel), os.path.join(tmp, "batch_host", rel),
                           rel.rsplit("-", 1)[1][: -len(".png")])
        apart += n
        same += n == 0
    say("batch", compare="device vs host", files=len(dev["pngs"]), extrema_json="identical", raw_pngs=len(raw),
        raw_byte_or_pixel_identical=same, pixels_one_bin_apart=apart,
        device_archive_s=f"{dev['seconds']:.2f}", host_archive_s=f"{host['seconds']:.2f}",
        device_panels_per_s=f"{PANELS_PER_FIGURE * len(dev['pngs']) / dev['seconds']:.2f}",
        host_panels_per_s=f"{PANELS_PER_FIGURE * len(host['pngs']) / host['seconds']:.2f}")

    # The single-figure FAST CLI on the device backend, from the device batch's working directory.
    big = max(mapping)
    os.environ["CST_RENDER_BACKEND"] = "device"
    here = os.getcwd()
    os.chdir(os.path.join(tmp, "batch_device"))
    K.reset_launches()
    secs = {}
    try:
        for mode, argv in (
            ("cdf-file", ["--cdf-file", mapping[big]["ees"]]),
            ("data-folder", ["--data-folder", root, "--orbit", str(big)]),
            ("instrument-file", [a for inst in ("ees", "eeb", "ies", "ieb")
                                 for a in ("--instrument-file", f"{inst}={mapping[big][inst]}")]),
        ):
            out = os.path.join(tmp, f"single_fast_{mode}.png")
            t0 = time.perf_counter()
            rc = call_main(cli_fast.main, [*argv, "--output", out, "--y-scale", "log", "--z-scale", "log",
                                           "--colormap", "inferno"])
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t0
            require(rc == 0 and os.path.exists(out), f"single FAST CLI {mode} exited {rc}")
    finally:
        os.chdir(here)
    launches = dict(K.LAUNCHES)
    say("batch", cli="single_plot_FAST_spectrograms", orbit=big, **{f"{m}_s": f"{s:.2f}" for m, s in secs.items()},
        launches=json.dumps(launches))
    say("batch", cli="single_plot_FAST_spectrograms", mode="date", run="no",
        why="--date downloads from CDA Web; the card's machine has no network")
    require(launches["collapse"] > 0, f"the single FAST CLI launched no collapse kernel: {launches}")
    add_launches(records, launches)
    os.environ.pop("CST_RENDER_BACKEND", None)
    return runs


#: Where a probed front-end child writes its launch counts and device (set before each press).
GUI_PROBE_ENV = "CHIP_SMOKE_GUI_PROBE"
GUI_MODULE = "configurable_spectrograms_torch.cli.GUI_batch_download_plot_FAST"
GUI_TIMEOUT_S = 300  # the longest wait for one front-end action


def _gui_probe(name: str, module: str, args: tuple, kwargs: dict) -> None:
    """In a front-end's spawned child: the port's real target *name*; then the child's launches, device and times to a JSON file.

    *module* is what the target imports first; it is imported ahead of the
    target so that ``target_import_s`` and ``target_s`` split the two.
    """
    t_entry = time.time()
    import importlib

    import torch

    t_torch = time.time()
    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui
    from configurable_spectrograms_torch.ops import _build
    from configurable_spectrograms_torch.ops import kernels as K
    from configurable_spectrograms_torch.utils import timing
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    t_import = time.time()
    device = get_device()
    torch.zeros(1, device=device)  # the child's CUDA context
    t_context = time.time()
    if device.type == "cuda":
        _build.load_library()  # the kernels the parent built, from build/cst_torch/
    t_library = time.time()
    importlib.import_module(module)
    t_target_import = time.time()
    record = {"device": str(device), "entry": t_entry, "torch_import_s": t_torch - t_entry,
              "port_import_s": t_import - t_torch, "context_s": t_context - t_import,
              "library_s": t_library - t_context, "target_import_s": t_target_import - t_library}
    timer = timing.ACTIVE = timing.StageTimer("gui_child")  # composite, png_encode, device_readback (summed over threads)
    try:
        getattr(gui, name)(*args, **kwargs)
        sync()
    finally:
        record.update(target_s=time.time() - t_target_import, stages=dict(timer.totals), launches=dict(K.LAUNCHES))
        with open(os.environ[GUI_PROBE_ENV], "w") as f:
            json.dump(record, f)


def _gui_probe_single(*args, **kwargs) -> None:
    _gui_probe("single_in_process", "configurable_spectrograms_torch.cli.single_plot_FAST_spectrograms", args, kwargs)


def _gui_probe_plot(*args, **kwargs) -> None:
    _gui_probe("plot_in_process", "configurable_spectrograms_torch.fast.batch_directory", args, kwargs)


def qt_session(hook) -> None:
    """The port's Qt front-end (``run_qt()``) on its headless stand-in, driven by ``hook(app, qt)``; re-raises what the hook raised."""
    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui
    from configurable_spectrograms_torch.gui import headless_qt as qt

    errors: list[BaseException] = []

    def wrapped(app):
        try:
            hook(app, qt)
        except BaseException as exc:  # raised again after exec() returns
            errors.append(exc)
        finally:
            app.quit()

    qt.install(force=True)  # the stand-in even where a real PySide6 is installed: there is no display
    qt.QApplication.exec_hook = wrapped
    try:
        require(gui.run_qt() == 0, "[gui] run_qt() exited non-zero")
    finally:
        qt.QApplication.exec_hook = None
        qt.QApplication._instance = None
        qt.uninstall()
    if errors:
        raise errors[0]


def qt_page(app, qt, index: int) -> tuple[dict, dict, object, object]:
    """Page *index*: its fields by label, its buttons by text, its status and progress labels."""
    page = app.topLevelWidgets()[0].findChildren(qt.QStackedWidget)[0].widget(index)
    fields: dict = {}

    def walk(layout):
        for item in layout._items:
            if isinstance(item, qt._BoxLayout):
                row = item._items
                if len(row) >= 2 and isinstance(row[0], qt.QLabel) and isinstance(row[1], qt.QLineEdit):
                    fields[row[0].text()] = row[1]
                else:
                    walk(item)

    walk(page.layout())
    labels = page.findChildren(qt.QLabel)
    return fields, {b.text(): b for b in page.findChildren(qt.QPushButton)}, labels[-2], labels[-1]


def qt_wait(app, predicate, what: str, timeout: float = GUI_TIMEOUT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        app.processEvents()
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"[gui] timed out after {timeout} s waiting for {what}")


def qt_press(app, qt, index: int, values: dict, button: str, probe: str, until=lambda: True) -> dict:
    """Fill page *index*, press *button*, wait until its child has ended, the status left "Running..." and *until*().

    Returns the status and the seconds: press to the child's exit, press
    to the status change, and the child's probe record (None if it wrote
    none).
    """
    import multiprocessing

    fields, buttons, status, _ = qt_page(app, qt, index)
    for name, value in values.items():
        fields[name].type_text(value)
    os.environ[GUI_PROBE_ENV] = probe
    before = set(multiprocessing.active_children())
    t_wall, t0 = time.time(), time.perf_counter()
    buttons[button].click()
    require(status.text() == "Running...", f"[gui] {button}: status {status.text()!r} after the press")
    (child,) = [p for p in multiprocessing.active_children() if p not in before]
    seen = {}

    def ended():
        now = time.perf_counter()
        if "exit" not in seen and not child.is_alive():
            seen["exit"] = now - t0
        if "status" not in seen and status.text() != "Running...":
            seen["status"] = now - t0
        return len(seen) == 2 and until()

    qt_wait(app, ended, f"{button} to end")
    record = None
    if os.path.exists(probe):
        with open(probe) as f:
            record = json.load(f)
        record["boot_s"] = record["entry"] - t_wall
    return {"status": status.text(), "exit_s": seen["exit"], "status_s": seen["status"], "child": record,
            "exitcode": child.exitcode}


def compute_app_pids() -> list[int]:
    """The pids nvidia-smi lists as holding a CUDA context (it may list none inside a container)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.isdigit()]


def pngs_under(path: str, base: str) -> list[str]:
    return sorted(os.path.relpath(p, base) for p in glob.glob(os.path.join(path, "**", "*.png"), recursive=True))


def combo_subset(d: dict, combo: str) -> dict:
    """The entries of an extrema JSON that belong to one scale combo (``log_log``: its cursor and each instrument's)."""
    return {k: v for k, v in d.items() if f"_{combo}_" in f"_{k}"}


def say_action(check: str, run: dict, **fields) -> None:
    child = run["child"] or {}
    say("gui", check=check, status=repr(run["status"]), exitcode=run["exitcode"],
        press_to_child_exit_s=f"{run['exit_s']:.2f}", press_to_status_s=f"{run['status_s']:.2f}",
        **({"child_boot_s": f"{child['boot_s']:.2f}", "child_torch_import_s": f"{child['torch_import_s']:.2f}",
            "child_port_import_s": f"{child['port_import_s']:.2f}", "child_context_s": f"{child['context_s']:.2f}",
            "child_library_s": f"{child['library_s']:.2f}",
            "child_target_import_s": f"{child['target_import_s']:.2f}", "child_target_s": f"{child['target_s']:.2f}",
            "child_stage_s": ",".join(f"{k}:{v:.2f}" for k, v in sorted(child["stages"].items())),
            "child_device": child["device"],
            "child_launches": json.dumps(child["launches"]).replace(" ", "")} if child else {}),
        **fields)


def run_gui(records: dict, mapping: dict, root: str, cusp: str, tmp: str, device_run: dict) -> None:
    """[gui]: the port's front-end with its actions in spawned children; (a) Single Day, (b) Plot, (c) Stop and resume, (d) --tui.

    Runs after [batch] and holds the front-end's outputs against what
    [batch] wrote in ``tmp/batch_device`` (*device_run*): its single-figure
    PNGs and its flagship tree.  The Qt actions run ``run_qt()`` on the
    headless stand-in, with the page's target swapped for a probe that
    runs the real target in the child and reports the child's launches.
    """
    import multiprocessing

    import torch

    from configurable_spectrograms_torch.cli import GUI_batch_download_plot_FAST as gui
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    on_card = torch.cuda.is_available()
    want_device = str(get_device())
    big = max(mapping)
    batch_tree = os.path.join(tmp, "batch_device")
    batch_pngs = sorted(device_run["pngs"])
    with open(os.path.join(batch_tree, "FAST_calculated_extrema.json")) as f:
        batch_extrema = json.load(f)
    here = os.getcwd()
    saved = {k: os.environ.get(k) for k in ("CST_RENDER_BACKEND", GUI_PROBE_ENV)}
    targets = (gui.single_in_process, gui.plot_in_process)
    os.environ["CST_RENDER_BACKEND"] = "device"
    gui.single_in_process, gui.plot_in_process = _gui_probe_single, _gui_probe_plot
    t_phase = time.perf_counter()
    try:
        # (a) Single Day: folder + orbit, against the single FAST CLI's --data-folder figure from [batch].
        os.chdir(batch_tree)  # ./FAST_Cusp_Indices.csv, as for the single FAST CLI
        out = os.path.join(tmp, "gui_single_day.png")
        runs = {}

        def single_day(app, qt):
            runs["a"] = qt_press(app, qt, 2, {"Data folder": root, "Orbit": str(big), "Output PNG": out,
                                              "Style y-z[-cmap]": "log-log-inferno"}, "Render",
                                 os.path.join(tmp, "gui_probe_a.json"))

        qt_session(single_day)
        a = runs["a"]
        same = a["child"] is not None and os.path.exists(out) and decoded_pixels_equal(
            out, os.path.join(tmp, "single_fast_data-folder.png"))
        say_action("a_single_day", a, orbit=big, pixels_equal_single_cli=same)
        require(a["status"] == "Finished.", f"[gui] (a) Single Day ended {a['status']!r}")
        require(a["child"]["device"] == want_device, f"[gui] (a) child ran on {a['child']['device']}")
        require(a["child"]["launches"]["collapse"] > 0, f"[gui] (a) the child launched no collapse: {a['child']}")
        require(same, "[gui] (a) the Single Day PNG differs from the single FAST CLI's")
        add_launches(records, a["child"]["launches"])

        # (b) Plot, one combo, into a fresh tree: the [batch] device tree's log_log subset.
        plot_cwd = batch_cwd(os.path.join(tmp, "gui_plot"), root, cusp)
        os.chdir(plot_cwd)  # the progress and extrema JSONs land here
        labels = []

        def plot(app, qt):
            progress = qt_page(app, qt, 1)[3]
            runs["b"] = qt_press(app, qt, 1, {"Data folder": root, "Output folder": os.path.join(plot_cwd, "FAST_plots"),
                                              "Percentile": "99", "Scale combos": "log-log"}, "Plot",
                                 os.path.join(tmp, "gui_probe_b.json"),
                                 until=lambda: "log_log @ orbit" in progress.text())
            labels.append(progress.text())

        qt_session(plot)
        b = runs["b"]
        got = pngs_under(os.path.join(plot_cwd, "FAST_plots"), plot_cwd)
        want = [p for p in batch_pngs if "_y-log_z-log_" in p]
        with open(os.path.join(plot_cwd, "FAST_calculated_extrema.json")) as f:
            extrema = json.load(f)
        raw = [p for p in got if "_raw-" in p]
        raw_equal = sum(decoded_pixels_equal(os.path.join(plot_cwd, p), os.path.join(batch_tree, p)) for p in raw)
        say_action("b_plot", b, progress=repr(labels[0]), pngs=len(got), batch_log_log_pngs=len(want),
                   extrema_keys=len(extrema), raw_pngs=len(raw), raw_pixels_equal=raw_equal)
        require(b["status"] == "Finished.", f"[gui] (b) Plot ended {b['status']!r}")
        require(b["child"]["device"] == want_device, f"[gui] (b) child ran on {b['child']['device']}")
        require(min(b["child"]["launches"]["collapse"], b["child"]["launches"]["fused_quantize"]) > 0,
                f"[gui] (b) the child did not launch both kernels: {b['child']['launches']}")
        require(got == want, f"[gui] (b) wrote another file list than [batch]'s log_log subset ({len(got)} vs {len(want)})")
        # A fresh log_log pre-pass scans in linear space and keeps what [batch]'s first combo
        # (linear_linear) scanned; [batch] derived its log_log entries from those (JAX semantics).
        require(extrema == {k.replace("linear_linear", "log_log"): v
                            for k, v in combo_subset(batch_extrema, "linear_linear").items()},
                "[gui] (b) the extrema JSON differs from the [batch] tree's linear_linear scan")
        require(raw and raw_equal == len(raw), f"[gui] (b) {len(raw) - raw_equal} raw-named PNGs differ from [batch]'s")
        add_launches(records, b["child"]["launches"])

        # (c) Stop after the first progress line, then Plot again: it resumes and ends with the whole tree.
        # Two combos, log_log first: the progress JSON is first written when a combo drains, so the
        # stop lands while the child works on linear_log.
        stop_cwd = batch_cwd(os.path.join(tmp, "gui_stop"), root, cusp)
        os.chdir(stop_cwd)
        stop = {}

        def stop_and_resume(app, qt):
            fields, buttons, status, progress = qt_page(app, qt, 1)
            values = {"Data folder": root, "Output folder": os.path.join(stop_cwd, "FAST_plots"), "Percentile": "99",
                      "Scale combos": "log-log linear-log"}
            for name, value in values.items():
                fields[name].type_text(value)
            os.environ[GUI_PROBE_ENV] = os.path.join(tmp, "gui_probe_c_stopped.json")
            before = set(multiprocessing.active_children())
            t0 = time.perf_counter()
            buttons["Plot"].click()
            (child,) = [p for p in multiprocessing.active_children() if p not in before]
            qt_wait(app, lambda: progress.text() != "" or not child.is_alive(), "the first progress line")
            stop["first_progress_s"] = time.perf_counter() - t0
            stop["progress"] = progress.text()
            stop["alive_at_stop"] = child.is_alive()
            stop["pngs_at_stop"] = len(pngs_under(os.path.join(stop_cwd, "FAST_plots"), stop_cwd))
            pids = compute_app_pids() if on_card else []
            stop["listed"] = child.pid in pids
            stop["apps_before"] = len(pids)
            t1 = time.perf_counter()
            buttons["Stop"].click()
            stop["status"] = status.text()

            def gone():
                if child.is_alive():
                    return False
                if not on_card:
                    return True
                pids = compute_app_pids()
                stop["apps_after"] = len(pids)
                return child.pid not in pids and (stop["apps_before"] == 0 or len(pids) < stop["apps_before"])

            qt_wait(app, gone, "the stopped child to leave the card", timeout=10)
            stop["gone_s"] = time.perf_counter() - t1
            time.sleep(0.5)
            app.processEvents()
            stop["status_later"] = status.text()
            runs["c"] = qt_press(app, qt, 1, {}, "Plot", os.path.join(tmp, "gui_probe_c.json"))

        qt_session(stop_and_resume)
        c = runs["c"]
        got_c = pngs_under(os.path.join(stop_cwd, "FAST_plots"), stop_cwd)
        tmp_left = glob.glob(os.path.join(stop_cwd, "FAST_plots", "**", "*.tmp-*"), recursive=True)
        want_lin = [p for p in batch_pngs if "_y-linear_z-log_" in p]
        say("gui", check="c_stop", progress=repr(stop["progress"]), first_progress_s=f"{stop['first_progress_s']:.2f}",
            alive_at_stop=stop["alive_at_stop"], pngs_at_stop=stop["pngs_at_stop"], status=repr(stop["status"]),
            status_after_0_5_s=repr(stop["status_later"]), gone_s=f"{stop['gone_s']:.2f}",
            **({"nvidia_smi_listed_child": stop["listed"], "compute_apps_before": stop["apps_before"],
                "compute_apps_after": stop.get("apps_after")} if on_card
               else {"nvidia_smi": "skipped", "why": "no card: the child's exit is checked with is_alive() only"}))
        say_action("c_resume", c, pngs=len(got_c), tmp_files_left=len(tmp_left))
        require(stop["alive_at_stop"], "[gui] (c) the child ended before Stop: nothing was stopped")
        require(stop["status"] == "Stopped." and stop["status_later"] == "Stopped.",
                f"[gui] (c) status after Stop: {stop['status']!r}, then {stop['status_later']!r}")
        require(c["status"] == "Finished.", f"[gui] (c) the resumed Plot ended {c['status']!r}")
        require([p for p in got_c if "_y-log_z-log_" in p] == got, "[gui] (c) the log_log files differ from (b)'s")
        require([p for p in got_c if "_y-linear_z-log_" in p] == want_lin and len(got_c) == len(got) + len(want_lin),
                "[gui] (c) the linear_log files differ from [batch]'s")
        require(not tmp_left, f"[gui] (c) temporary files left: {tmp_left[:3]}")
        require(c["child"]["device"] == want_device, f"[gui] (c) child ran on {c['child']['device']}")
        add_launches(records, c["child"]["launches"])

        # (d) The terminal menu in its own process: Single Day, pitch-angle, the 8192x64x128 ees file.
        os.chdir(batch_tree)
        out_d = os.path.join(tmp, "gui_tui_pitch.png")
        answers = f"3\npitch-angle\n{out_d}\nlog-log-inferno\n\n{mapping[big]['ees']}\nq\n"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (os.path.dirname(os.path.abspath(__file__)),
                                                        env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", GUI_MODULE, "--tui"], input=answers, text=True, cwd=batch_tree,
                              env=env, capture_output=True, timeout=GUI_TIMEOUT_S)
        tui_s = time.perf_counter() - t0
        same_d = proc.returncode == 0 and os.path.exists(out_d) and decoded_pixels_equal(
            out_d, os.path.join(tmp, "single_fast_cdf-file.png"))
        say("gui", check="d_tui", rc=proc.returncode, done="Done." in proc.stdout, seconds=f"{tui_s:.2f}",
            pixels_equal_single_cli=same_d)
        require(proc.returncode == 0 and "Done." in proc.stdout,
                f"[gui] (d) the TUI exited {proc.returncode}: {proc.stdout[-800:]} {proc.stderr[-1500:]}")
        require(same_d, "[gui] (d) the TUI's pitch-angle PNG differs from the single FAST CLI's")
        say("gui", phase_s=f"{time.perf_counter() - t_phase:.2f}")
    finally:
        gui.single_in_process, gui.plot_in_process = targets
        os.chdir(here)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for p in multiprocessing.active_children():  # stop every process the phase started
            p.kill()
            p.join()


PARALLEL_FILES = 8  # cubes of the [parallel] extrema check, at PARALLEL_SHAPE: 2.15 GB, 1.07 GB a rank
PARALLEL_SHAPE = SHAPES[0]
#: Their t_valids at T = 8192 (scaled to another T); 3001 leaves no real row in the second time half.
PARALLEL_T_VALIDS = (8192, 8192, 5000, 8192, 3001, 8192, 8192, 7777)


def sync() -> None:
    """Wait for the card, where there is one (a spawned rank of a rehearsal on the CPU has none)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def write_parallel_cubes(path: str, shape=SHAPES[0], seed: int = 7) -> np.ndarray:
    """The [parallel] extrema batch, (PARALLEL_FILES, T, A, E) float32 with NaN and negative cells, as a .npy at *path*.

    Written file by file into a memory-mapped .npy, so each rank can read
    only its block.  Returns the t_valids.
    """
    T, A, E = shape
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=(PARALLEL_FILES, T, A, E))
    rng = np.random.default_rng(seed)
    for i in range(PARALLEL_FILES):
        x = rng.random((T, A, E), dtype=np.float32)
        cube = x * np.float32(50.0) - np.float32(0.5)
        cube[x < 0.02] = np.nan
        out[i] = cube
    out.flush()
    del out
    return np.array([t * T // 8192 for t in PARALLEL_T_VALIDS], np.int32)


def _parallel_extrema_rank(rank: int, path: str, t_valids: np.ndarray) -> dict:
    """[parallel] (a), one rank: sharded_extrema_stats over a ('data',) mesh of 2 and a ('data', 'time') mesh of 1x2."""
    from configurable_spectrograms_torch.ops import kernels as K
    from configurable_spectrograms_torch.parallel import make_mesh, sharded_extrema_stats
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    cubes = np.load(path, mmap_mode="r")  # this rank reads only its block
    out = {"device": str(get_device())}
    for name, mesh in (("data2", make_mesh(2)), ("data1xtime2", make_mesh(2, ("data", "time"), (1, 2)))):
        K.reset_launches()
        sync()
        t0 = time.perf_counter()
        counts, hist = sharded_extrema_stats(cubes, t_valids, mesh)
        sync()
        out[name] = {"counts": counts, "hist": hist, "seconds": time.perf_counter() - t0,
                     "launches": dict(K.LAUNCHES)}
    return out


def _parallel_flagship_rank(rank: int, cwd: str) -> dict:
    """[parallel] (c), one rank: the flagship CLI at one worker thread in *cwd* (each rank plots orbits rank::2)."""
    from configurable_spectrograms_torch.ops import extrema_ops
    from configurable_spectrograms_torch.ops import kernels as K
    from configurable_spectrograms_torch.render import dispatch
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    K.reset_launches()
    run = run_flagship(cwd, "device", workers=1)
    return {"run": run, "launches": dict(K.LAUNCHES), "device": str(get_device()),
            "render_device": dispatch.LAST_DISPATCH["device"], "extrema_device": extrema_ops.LAST_DISPATCH["device"]}


def decoded_pixels_equal(a_path: str, b_path: str) -> bool:
    from PIL import Image

    with Image.open(a_path) as a, Image.open(b_path) as b:
        return np.array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))


def run_parallel(records: dict, mapping: dict, root: str, cusp: str, tmp: str, ungrouped: dict) -> None:
    """[parallel]: the collective extrema in two ranks, the flagship under one NCCL rank and in two ranks, entry(), NCCL on two cards."""
    import socket

    import torch
    import torch.distributed as dist

    from configurable_spectrograms_torch.entry import dryrun_multichip, spawn_ranks
    from configurable_spectrograms_torch.ops import extrema_ops
    from configurable_spectrograms_torch.ops import kernels as K
    from configurable_spectrograms_torch.ops.extrema_ops import batched_file_stats
    from configurable_spectrograms_torch.parallel.mesh import init_distributed, shutdown_distributed
    from configurable_spectrograms_torch.render import dispatch
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    device = get_device()  # cuda:0 (a CPU rehearsal: cpu)
    # (a) Two Gloo ranks on the one card: sharded_extrema_stats against one process's batched_file_stats.
    path = os.path.join(tmp, "parallel_cubes.npy")
    t0 = time.perf_counter()
    t_valids = write_parallel_cubes(path, PARALLEL_SHAPE)
    cubes = np.load(path, mmap_mode="r")
    ref = batched_file_stats([cubes[i, : t_valids[i]] for i in range(PARALLEL_FILES)])
    torch.cuda.synchronize()
    ref_counts = np.stack([r["counts"] for r in ref])
    ref_hist = np.sum([r["hist"] for r in ref], axis=0).astype(np.int64)
    say("parallel", part="a", step="inputs", files=PARALLEL_FILES, shape="x".join(map(str, cubes.shape[1:])),
        gbytes=f"{cubes.nbytes / 1e9:.2f}", t_valids=",".join(map(str, t_valids)),
        seconds=f"{time.perf_counter() - t0:.2f}")
    del cubes
    t0 = time.perf_counter()
    ranks = spawn_ranks(_parallel_extrema_rank, 2, "gloo", args=(path, t_valids), local_ranks=[0, 0], timeout=600)
    wall = time.perf_counter() - t0
    os.remove(path)
    for mesh in ("data2", "data1xtime2"):
        for r, out in enumerate(ranks):
            got = out[mesh]
            require(np.array_equal(got["counts"], ref_counts), f"(a) {mesh} rank {r}: counts differ from batched_file_stats")
            require(np.array_equal(got["hist"], ref_hist), f"(a) {mesh} rank {r}: histogram differs from batched_file_stats")
            require(got["launches"]["collapse"] > 0, f"(a) {mesh} rank {r} launched no collapse kernel: {got['launches']}")
            require(out["device"] == str(device), f"(a) rank {r} computed on {out['device']}")
            add_launches(records, got["launches"])
        say("parallel", part="a", mesh=mesh, ranks=2, backend="gloo", stats="bit-equal to batched_file_stats",
            seconds=",".join(f"{o[mesh]['seconds']:.3f}" for o in ranks),
            launches=",".join(json.dumps(o[mesh]["launches"]).replace(" ", "") for o in ranks),
            positives=int(ref_hist.sum()))
    say("parallel", part="a", spawn_and_run_s=f"{wall:.2f}")

    # (b) One NCCL rank through init_distributed() with torchrun's variables: the flagship as run ungrouped.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torchrun = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in torchrun}
    os.environ.update(torchrun)
    cwd = batch_cwd(os.path.join(tmp, "parallel_nccl"), root, cusp)
    try:
        init_distributed()
        backend = dist.get_backend()
        require(backend == ("nccl" if device.type == "cuda" else "gloo"), f"(b) backend {backend}")
        one = torch.ones((1,), device=device)
        dist.all_reduce(one)
        K.reset_launches()
        dispatch.LAST_DISPATCH["device"] = extrema_ops.LAST_DISPATCH["device"] = None
        run = run_flagship(cwd, "device")
        launches = dict(K.LAUNCHES)
    finally:
        shutdown_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    say("parallel", part="b", ranks=1, backend=backend, archive_s=f"{run['seconds']:.2f}", pngs=len(run["pngs"]),
        render_device=dispatch.LAST_DISPATCH["device"], extrema_device=extrema_ops.LAST_DISPATCH["device"],
        launches=json.dumps(launches).replace(" ", ""))
    require(run["rc"] == 0 and all(r["status"] == "ok" for r in run["results"]), "(b) the one-rank flagship failed")
    require(sorted(run["pngs"]) == sorted(ungrouped["pngs"]), "(b) the one-rank flagship wrote another file list")
    require(run["extrema"] == ungrouped["extrema"], "(b) the one-rank flagship's extrema JSON differs")
    require(dispatch.LAST_DISPATCH["device"] == extrema_ops.LAST_DISPATCH["device"] == str(device),
            f"(b) the one-rank flagship did not run on {device}")
    require(min(launches["collapse"], launches["fused_quantize"]) > 0, f"(b) a kernel never launched: {launches}")
    add_launches(records, launches)

    # (c) Two Gloo ranks on the one card, the flagship at one worker on the three small orbits.
    small = sorted(mapping)[:3]
    data = os.path.join(tmp, "parallel_small_data")
    for orbit in small:
        for f in mapping[orbit].values():
            os.makedirs(os.path.join(data, os.path.dirname(os.path.relpath(f, root))), exist_ok=True)
            os.symlink(f, os.path.join(data, os.path.relpath(f, root)))
    one = run_flagship(batch_cwd(os.path.join(tmp, "parallel_one"), data, cusp), "device", workers=1)
    require(one["rc"] == 0 and all(r["status"] == "ok" for r in one["results"]), "(c) the one-process flagship failed")
    cwd2 = batch_cwd(os.path.join(tmp, "parallel_two"), data, cusp)
    t0 = time.perf_counter()
    two = spawn_ranks(_parallel_flagship_rank, 2, "gloo", args=(cwd2,), local_ranks=[0, 0], timeout=600)
    wall = time.perf_counter() - t0
    union = {}
    for r, out in enumerate(two):
        run = out["run"]
        require(run["rc"] == 0 and all(x["status"] == "ok" for x in run["results"]), f"(c) rank {r} failed")
        require(out["render_device"] == out["extrema_device"] == out["device"] == str(device),
                f"(c) rank {r} ran on {out['render_device']} / {out['extrema_device']}")
        # At one worker the raw job of an orbit writes the given-named files too and the given job finds
        # them (docs/parity.md:42-46), so only the collapse kernel renders.
        require(out["launches"]["collapse"] > 0, f"(c) rank {r}: the collapse kernel never launched: {out['launches']}")
        add_launches(records, out["launches"])
        union.update(run["pngs"])
    require(sorted(union) == sorted(one["pngs"]), "(c) the two ranks wrote another file list than one process")
    for rel in one["pngs"]:
        require(decoded_pixels_equal(os.path.join(tmp, "parallel_one", rel), os.path.join(cwd2, rel)),
                f"(c) {rel}: the two-rank PNG decodes to other pixels")
    require(two[0]["run"]["extrema"] == two[1]["run"]["extrema"] == one["extrema"],
            "(c) the ranks' .proc extrema JSONs differ (from each other or from one process)")
    rank_s = max(o["run"]["seconds"] for o in two)
    say("parallel", part="c", orbits=len(small), pngs=len(union), pixels="identical", extrema_json="proc0 == proc1",
        one_rank_s=f"{one['seconds']:.2f}", two_rank_s=f"{rank_s:.2f}", two_rank_spawn_s=f"{wall:.2f}",
        one_rank_extrema_s=f"{one['extrema_s']:.2f}",
        two_rank_extrema_s=",".join(f"{o['run']['extrema_s']:.2f}" for o in two),
        two_rank_each_s=",".join(f"{o['run']['seconds']:.2f}" for o in two),
        one_rank_panels_per_s=f"{PANELS_PER_FIGURE * len(one['pngs']) / one['seconds']:.2f}",
        two_rank_panels_per_s=f"{PANELS_PER_FIGURE * len(union) / rank_s:.2f}",
        note="one card, informative only", launches=",".join(json.dumps(o["launches"]).replace(" ", "") for o in two))

    # (d) entry()'s forward on the card against the same forward on the CPU.
    run_entry(records)

    # (e) NCCL with two ranks on two cards.
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        t0 = time.perf_counter()
        recs = dryrun_multichip(2, "nccl")
        require([r["device"] for r in recs] == ["cuda:0", "cuda:1"], f"(e) devices {recs}")
        say("parallel", part="e", nccl_two_cards="ok", devices=n_cards, seconds=f"{time.perf_counter() - t0:.2f}",
            ranks=json.dumps(recs).replace(" ", ""))
    else:
        say("parallel", part="e", nccl_two_cards="not_run", devices=n_cards)


def run_entry(records: dict) -> None:
    """[parallel] (d): ``entry()``'s forward on the card against the CPU's, to the parity contract."""
    import torch

    from configurable_spectrograms_torch.entry import T_ENTRY, entry
    from configurable_spectrograms_torch.ops import kernels as K
    from configurable_spectrograms_torch.ops._colormap_data import colormap_lut
    from configurable_spectrograms_torch.ops.spectrogram import RenderSpec, collapse_cube, quantize_matrix
    from configurable_spectrograms_torch.render.host_quantize import host_collapse
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    fn, args = entry()
    require(all(a.device == get_device() for a in args), "(d) entry()'s arguments are not on the port's device")
    K.reset_launches()
    rgba, vmin, vmax = (x.cpu().numpy() for x in fn(*args))
    launches = dict(K.LAUNCHES)
    fn_cpu, args_cpu = entry(torch.device("cpu"))
    rgba_h, vmin_h, vmax_h = (x.numpy() for x in fn_cpu(*args_cpu))
    require(np.array_equal(vmin, vmin_h) and np.array_equal(vmax, vmax_h),
            f"(d) bounds card {vmin!r}, {vmax!r} vs cpu {vmin_h!r}, {vmax_h!r}")

    def index_matrix(a):  # the forward's colormap indices, before the resample
        cube, mask, energy, e_valid, _, z_bounds, _ = a
        d = cube.device
        one = [torch.full((1,), v, dtype=torch.int32, device=d) for v in (T_ENTRY, 0, T_ENTRY)]
        q = quantize_matrix(collapse_cube(cube, mask, T_ENTRY)[None], energy[None], e_valid[None], *one,
                            z_bounds[None], RenderSpec(8, 8, "log", "log"))
        return q["idx"][0].cpu().numpy().astype(np.int32)

    diff = np.abs(index_matrix(args) - index_matrix(args_cpu))
    require(int(diff.max()) <= 1, f"(d) index cells {int(diff.max())} bins apart")
    on_edge = boundary_mask(host_collapse(args_cpu[0].numpy(), args_cpu[1].numpy()), float(vmin_h), float(vmax_h),
                            "log", diff > 0)
    require(int(on_edge.sum()) == int((diff > 0).sum()), "(d) index cells one bin apart away from a bin boundary")
    lut = colormap_lut("inferno").astype(np.int64)
    code = {tuple(c): i for i, c in enumerate(lut)}
    px = (rgba != rgba_h).any(axis=-1)
    require(all(abs(code.get(tuple(a), -9) - code.get(tuple(b), -99)) == 1
                for a, b in zip(rgba[px].astype(np.int64), rgba_h[px].astype(np.int64))),
            "(d) tile pixels differ by more than one colormap entry")
    require(launches["collapse"] > 0, f"(d) the forward launched no collapse kernel: {launches}")
    add_launches(records, launches)
    say("parallel", part="d", entry="forward", shape="x".join(map(str, rgba.shape)), vmin=float(vmin),
        vmax=float(vmax), bounds="bit-exact", cells=diff.size, cells_one_bin_apart=int((diff > 0).sum()),
        pixels_one_bin_apart=int(px.sum()), launches=json.dumps(launches).replace(" ", ""))


#: The render back end's switches one at a time, for --backend-switches.
BACKEND_SWITCHES = (
    ("on", {}),
    ("cache_off", {"CST_DEVICE_CUBE_CACHE": "0"}),
    ("coalesce_off", {"CST_RENDER_COALESCE": "0"}),
    ("gate_off", {"CST_HOST_COMPUTE_GATE": "0"}),
    ("all_off", BACKEND_OFF),
)


def run_backend_switches(rounds: int, small=SHAPES[1], big=SHAPES[0]) -> dict:
    """The flagship batch on the device backend with each switch of the render back end off alone, *rounds* times.

    Each round runs every setting of :data:`BACKEND_SWITCHES` once, the
    order rotated by one each round, so a drift of the host's speed
    through the call spreads over all of them.  Every run must write the
    first run's file list and extrema JSON.  Returns each setting's
    panels/s and render panels/s (without the extrema pre-pass), run by run.
    """
    import statistics

    from configurable_spectrograms_torch.ops import kernels as K
    from configurable_spectrograms_torch.render.device_cache import upload_telemetry

    per = {name: {"panels_per_s": [], "render_panels_per_s": []} for name, _ in BACKEND_SWITCHES}
    first = None
    with tempfile.TemporaryDirectory(prefix="cst_chip_switches_") as tmp:
        root, mapping = make_archive(tmp, small, big)
        for r in range(rounds):
            order = BACKEND_SWITCHES[r % len(BACKEND_SWITCHES):] + BACKEND_SWITCHES[:r % len(BACKEND_SWITCHES)]
            for name, env in order:
                cwd = batch_cwd(os.path.join(tmp, f"switches_{r}_{name}"), root, os.path.join(tmp, "cusp.tsv"))
                K.reset_launches()
                before = upload_telemetry()
                saved = {k: os.environ.get(k) for k in env}
                os.environ.update(env)
                try:
                    run = run_flagship(cwd, "device")
                finally:
                    for k, v in saved.items():
                        if v is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = v
                tele = telemetry_since(before)
                panels = PANELS_PER_FIGURE * len(run["pngs"])
                pps, rpps = panels / run["seconds"], panels / (run["seconds"] - run["extrema_s"])
                per[name]["panels_per_s"].append(pps)
                per[name]["render_panels_per_s"].append(rpps)
                say("switches", round=r, run=name, env=json.dumps(env).replace(" ", ""),
                    archive_s=f"{run['seconds']:.2f}", extrema_s=f"{run['extrema_s']:.2f}", pngs=len(run["pngs"]),
                    panels_per_s=f"{pps:.2f}", render_panels_per_s=f"{rpps:.2f}", h2d_bytes=tele["upload_bytes"],
                    cube_hits=tele["cube_hits"], dispatches=tele["dispatches"], launches=json.dumps(K.LAUNCHES))
                require(run["rc"] == 0 and all(x["status"] == "ok" for x in run["results"]),
                        f"flagship CLI ({name}, round {r}) failed: rc {run['rc']}")
                require(min(K.LAUNCHES["collapse"], K.LAUNCHES["fused_quantize"]) > 0,
                        f"the flagship batch ({name}) did not launch both kernels: {K.LAUNCHES}")
                if first is None:
                    first = run
                require(sorted(run["pngs"]) == sorted(first["pngs"]), f"{name}, round {r}: another file list")
                require(run["extrema"] == first["extrema"], f"{name}, round {r}: another extrema JSON")
    for name, v in per.items():
        say("switches", setting=name, runs=len(v["panels_per_s"]),
            median_panels_per_s=f"{statistics.median(v['panels_per_s']):.2f}",
            median_render_panels_per_s=f"{statistics.median(v['render_panels_per_s']):.2f}")
    os.environ.pop("CST_RENDER_BACKEND", None)
    return per


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.astype("<i2").tobytes())


def run_audio(records: dict, samples: np.ndarray) -> None:
    """The audio CLI on the device backend, held against the numpy STFT and the host render."""
    import torch

    import PIL  # noqa: F401 - the CLI writes PNGs
    from configurable_spectrograms_torch.cli import audio as cli_audio
    from configurable_spectrograms_torch.ops import kernels as K
    from configurable_spectrograms_torch.ops.stft import audio_spectrogram_dataset
    from configurable_spectrograms_torch.render.device_cache import upload_telemetry
    from configurable_spectrograms_torch.render.plotting import generic_plot_spectrogram_set

    def figure_of(ds):
        fig, _ = generic_plot_spectrogram_set([ds], x_is_unix=False, z_scale="log", colormap="magma",
                                              y_min=float(ds["y"][0]), y_max=float(ds["y"][-1]))
        return fig

    with tempfile.TemporaryDirectory(prefix="cst_chip_audio_") as tmp:
        wav = os.path.join(tmp, "audio.wav")
        t0 = time.perf_counter()
        write_wav(wav, samples, AUDIO_RATE)
        signal, rate = cli_audio.load_wav(wav)
        t1 = time.perf_counter()
        os.environ["CST_RENDER_BACKEND"] = "host"
        host = {n: audio_spectrogram_dataset(signal, rate, n_mels=n, label="host") for n in (None, 128)}
        say("audio", seconds=AUDIO_SECONDS, rate=rate, samples=signal.size, wav_s=f"{t1 - t0:.2f}",
            host_stft_s=f"{time.perf_counter() - t1:.2f}", frames=host[None]["data"].shape[0])

        captured = []
        real = cli_audio.audio_spectrogram_dataset

        def capturing(*a, **k):
            t = time.perf_counter()
            ds = real(*a, **k)
            captured.append((ds, time.perf_counter() - t))
            return ds

        os.environ["CST_RENDER_BACKEND"] = "device"
        cli_audio.audio_spectrogram_dataset = capturing
        K.reset_launches()
        try:
            for method, n_mels in (("pallas", None), ("pallas", 128), ("fft", None), ("matmul", None)):
                out = os.path.join(tmp, f"{method}_{n_mels}.png")
                argv = ["--wav-file", wav, "--output", out, "--stft-method", method]
                t0 = time.perf_counter()
                rc = call_main(cli_audio.main, argv + (["--n-mels", str(n_mels)] if n_mels else []))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                require(rc == 0 and os.path.exists(out), f"audio CLI {method} n_mels={n_mels} exited {rc}")
                ds, stft_s = captured[-1]
                ref = host[n_mels]["data"][:, 0, :]
                got = ds["data"][:, 0, :]
                require(got.shape == ref.shape, f"{method}: shape {got.shape} vs host {ref.shape}")
                err, ratio = stft_tolerance(ref, got)
                say("audio", cli=method, n_mels=n_mels, rc=rc, cli_s=f"{secs:.2f}", stft_s=f"{stft_s:.3f}",
                    shape="x".join(map(str, ds["data"].shape)), vs_host_max_abs_err=err, tol_ratio=f"{ratio:.3e}")
                require(ratio <= 1.0, f"audio {method} n_mels={n_mels}: device vs host STFT ratio {ratio}")
        finally:
            cli_audio.audio_spectrogram_dataset = real
        launches = dict(K.LAUNCHES)
        say("audio", launches=json.dumps(launches))
        require(launches["stft_power"] > 0 and launches["collapse"] > 0,
                f"the audio path did not launch stft_power and collapse: {launches}")
        add_launches(records, launches)

        # Where one audio figure's time goes (the pallas raw dataset, 150 DPI as the CLI saves).
        fig = figure_of(captured[0][0])
        before = upload_telemetry()
        t0 = time.perf_counter()
        render_all(figure_panels([fig], dpi=150))
        torch.cuda.synchronize()
        dispatch_s = time.perf_counter() - t0
        first = telemetry_since(before)
        second = render_and_save([fig], 150, os.path.join(tmp, "breakdown"))
        say("breakdown", figure="audio_raw", stft_s=f"{captured[0][1]:.3f}", dispatch_s=f"{dispatch_s:.3f}",
            composite_s=f"{second['composite_s']:.3f}", png_s=f"{second['png_s']:.3f}",
            h2d_bytes=first["upload_bytes"], second_render_s=f"{second['render_s']:.3f}",
            second_h2d_bytes=second["h2d_bytes"])
        require(second["h2d_bytes"] == 0,
                f"the second audio render shipped {second['h2d_bytes']} bytes: its padded cube did not stay resident")

        # The host-computed datasets on both render backends.
        for n_mels, ds in host.items():
            panels = figure_panels([figure_of(ds)], dpi=150)
            results, secs = {}, {}
            for backend in ("device", "host"):
                os.environ["CST_RENDER_BACKEND"] = backend
                t0 = time.perf_counter()
                results[backend] = render_all(panels)
                torch.cuda.synchronize()
                secs[backend] = time.perf_counter() - t0
            cells, off, on_boundary = compare_panels(panels, results["device"], results["host"])
            T, A, E = panels[0][2].cube.shape
            say("audio", render="device vs host", n_mels=n_mels, shape=f"{T}x{A}x{E}", cells=cells,
                cells_one_bin_apart=off, of_them_on_a_bin_boundary=on_boundary, bounds="bit-exact",
                device_dispatch_s=f"{secs['device']:.3f}", host_dispatch_s=f"{secs['host']:.3f}")
        os.environ.pop("CST_RENDER_BACKEND", None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true", help="build and check the kernels only")
    ap.add_argument("--backend-switches", type=int, metavar="N", default=0,
                    help="only time the flagship batch with each render back-end switch off alone, N rounds")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from configurable_spectrograms_torch.ops import _build
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    os.environ.setdefault("CST_TORCH_DEVICE", "cuda")
    device = get_device()
    smi = nvidia_smi_line()
    libs = {}
    for mod in ("PIL", "pandas", "matplotlib", "tqdm"):
        try:
            __import__(mod)
            libs[mod] = "yes"
        except ImportError:
            libs[mod] = "no"
    say("device", nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
        **{f"import_{k}": v for k, v in libs.items()})

    t0 = time.perf_counter()
    _build.load_library()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", nvcc_seconds=f"{float(_build.BUILD_INFO['seconds']):.2f}",
        library=os.path.relpath(str(_build.BUILD_INFO["path"])))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write(str(_build.BUILD_INFO["log"]))

    if args.backend_switches:
        per = run_backend_switches(args.backend_switches)
        print(smi)
        print(json.dumps({"switches": per}))
        return 0

    records = check_kernels(device)
    samples = make_audio(AUDIO_SECONDS, AUDIO_RATE)
    records.update(check_stft_kernel(device, samples.astype(np.float32) / 32768.0))
    if not args.kernels:
        run_font_and_png()
        run_e2e(records)
        run_audio(records, samples)
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": r.get("launches"), "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in records.items()
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
