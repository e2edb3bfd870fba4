"""The audio CLI's mel path on long recordings: one user rendering log-mel figures one after another.

Set-up writes the cell's recordings from the seed (child processes,
under ``TMPDIR``), imports the port, loads its kernel library and PNG
encoder, and warms up with one figure.  The window renders the recordings
in turn, cycling, through ``cli.audio.render_audio_spectrogram`` at the
traffic's frame length, hop and mel bins with the CLI's other defaults
(``fft``, linear y, log z, magma, 150 DPI, the device back end), each
figure to a PNG of its own, until the window's seconds are reached; the
figure running then is finished.  ``audio_figure_s`` is the window's
seconds over the figures it finished, as in :mod:`drivers.audio_cli`.  A
new load makes new host arrays, so no cache of the port serves one figure
from another.  Traced runs keep the matrix shape of every
percentile-quantize launch for its roofline.

Afterwards every figure's PNG must exist and its y axis must be the mel
centres; the window's first figure and a share of the others drawn from
the seed have the rows of their mel spectrogram drawn from the seed held
to :mod:`reference.mel`, and figures drawn from the seed their tiles.
"""

from __future__ import annotations

import os
import time

import numpy as np

from drivers.audio_cli import add, new_tiles
from gen import audio as gen_audio
from harness.checks import at_least, at_most
from reference import audio as ref_audio
from reference import judge, layout
from reference import mel as ref_mel

SYNTH_WORKERS = min(8, os.cpu_count() or 1)


def sample_rows(seed: int, traffic: dict) -> np.ndarray:
    """The frames whose mel rows are compared, drawn from the seed."""
    n = int(float(traffic["seconds"]) * int(traffic["rate"]))
    frames = ref_mel.frame_starts(n, int(traffic["frame_length"]), int(traffic["hop_length"])).size
    rng = np.random.default_rng([seed % 2**63, 11])
    return np.sort(rng.choice(frames, size=min(int(traffic["sample_rows"]), frames), replace=False))


def shape(traffic: dict) -> tuple[int, int, int]:
    """(frame length, hop, mel bins)."""
    return int(traffic["frame_length"]), int(traffic["hop_length"]), int(traffic["n_mels"])


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.rec = ctx.recorder
        self.figures: list[dict] = []
        self.launch_shapes: dict[str, list] = {"percentile_quantize": []}
        self.launches = 0
        self.timer = None

    def setup(self) -> dict[str, float]:
        parts = {}
        os.environ["CST_RENDER_BACKEND"] = "device"
        t = time.perf_counter()
        root = os.path.join(self.ctx.scratch, "recordings")
        os.makedirs(root)
        self.wavs = gen_audio.write_recordings(root, self.ctx.seed, int(self.t["recordings"]),
                                               float(self.t["seconds"]), int(self.t["rate"]), SYNTH_WORKERS)
        parts["synthesis_s"] = time.perf_counter() - t
        t = time.perf_counter()
        from configurable_spectrograms_torch.cli import audio as cli_audio
        from configurable_spectrograms_torch.ops import kernels

        self.cli, self.kernels = cli_audio, kernels
        parts["import_port_s"] = time.perf_counter() - t
        if self.ctx.cuda:
            t = time.perf_counter()
            from configurable_spectrograms_torch.ops._build import load_library

            load_library()
            parts["kernel_library_s"] = time.perf_counter() - t
        t = time.perf_counter()
        from configurable_spectrograms_torch.render import fastpng

        fastpng.library()
        parts["png_encoder_s"] = time.perf_counter() - t
        self.out = os.path.join(self.ctx.scratch, "figures")
        os.makedirs(self.out)
        self.rows = sample_rows(self.ctx.seed, self.t)
        t = time.perf_counter()
        self._figure(0, os.path.join(self.out, "warmup.png"))
        parts["warmup_s"] = time.perf_counter() - t
        self.figures.clear()
        self.rec.spans.clear()
        return parts

    def _figure(self, k: int, path: str) -> dict:
        import torch

        real = self.cli.audio_spectrogram_dataset
        kept = {}
        keep = k == 0 or np.random.default_rng([self.ctx.seed % 2**63, 17, k]).random() < float(self.t["rows_share"])

        def dataset(*a, **kw):
            ds = real(*a, **kw)
            kept["y"] = np.array(ds["y"])
            if keep:
                kept["rows"] = np.array(ds["data"][self.rows, 0, :])
            return ds

        frame, hop, n_mels = shape(self.t)
        wav = self.wavs[k % len(self.wavs)]
        self.cli.audio_spectrogram_dataset = dataset
        t = time.perf_counter()
        try:
            with self.rec.span("figure"):
                ok = self.cli.render_audio_spectrogram(wav, path, frame_length=frame, hop_length=hop, n_mels=n_mels)
                if self.ctx.cuda:
                    torch.cuda.synchronize()
        finally:
            self.cli.audio_spectrogram_dataset = real
        fig = {"wav": wav, "png": path, "ok": bool(ok), "seconds": time.perf_counter() - t,
               "rows": kept.get("rows"), "y": kept.get("y")}
        self.figures.append(fig)
        return fig

    def window(self, seconds: float) -> dict:
        from configurable_spectrograms_torch.utils import timing

        unwrap = None
        if self.ctx.trace:
            self.timer = timing.ACTIVE = timing.StageTimer("benchmark")
            unwrap = self._keep_launch_shapes()
        launches0 = self.kernels.LAUNCHES.get("percentile_quantize", 0)
        t0 = time.perf_counter()
        k = 0
        try:
            while not self.figures or time.perf_counter() - t0 < seconds:
                self._figure(k, os.path.join(self.out, f"figure_{k}.png"))
                k += 1
        finally:
            elapsed = time.perf_counter() - t0
            timing.ACTIVE = None
            if unwrap:
                unwrap()
        self.launches = self.kernels.LAUNCHES.get("percentile_quantize", 0) - launches0
        failed = sum(not f["ok"] for f in self.figures)
        figure_s = elapsed / len(self.figures)
        log = {"figures": len(self.figures), "seconds": elapsed, "figure_s_mean": figure_s,
               "figure_s": [round(f["seconds"], 3) for f in self.figures],
               "percentile_quantize_launches": self.launches}
        return {"e2e": {"audio_figure_s": figure_s}, "attempted": len(self.figures), "failed": failed, "log": log,
                "timer": self.timer, "launch_shapes": self.launch_shapes}

    def _keep_launch_shapes(self):
        """Keep the matrix shape of each percentile-quantize call (traced runs only); returns the undo.

        Where the port has no such kernel (no ``percentile_quantize_lanes``),
        nothing is wrapped and the roofline reads nothing.
        """
        from configurable_spectrograms_torch.render import dispatch

        modules = [m for m in (self.kernels, dispatch) if hasattr(m, "percentile_quantize_lanes")]
        if not modules:
            return None
        real, kept = self.kernels.percentile_quantize_lanes, self.launch_shapes["percentile_quantize"]

        def launch(matrix, *rest, **kw):
            kept.append(tuple(matrix.shape))
            return real(matrix, *rest, **kw)

        for module in modules:
            module.percentile_quantize_lanes = launch

        def unwrap():
            for module in modules:
                module.percentile_quantize_lanes = real

        return unwrap

    def release(self) -> None:
        import gc

        gc.collect()
        if self.ctx.cuda:
            import torch

            torch.cuda.empty_cache()

    def check(self) -> list[dict]:
        frame, hop, n_mels = shape(self.t)
        missing = sum(not (f["ok"] and os.path.exists(f["png"])) for f in self.figures)
        text = layout.Text(str(self.ctx.root / layout.FONT))
        signals, spec = {}, {}
        for f in self.figures:
            if f["wav"] not in signals:
                signals[f["wav"]] = ref_audio.load(f["wav"])
                sig, rate = signals[f["wav"]]
                spec[f["wav"]] = ref_mel.mel_power(sig, rate, frame, hop, n_mels)
        with_rows = [f for f in self.figures if f["rows"] is not None]
        worst = max((ref_audio.err_ratio(spec[f["wav"]][self.rows], f["rows"]) for f in with_rows), default=0.0)
        centres = ref_mel.centres(n_mels, int(self.t["rate"]))
        axis = max((ref_mel.centres_rel_err(centres, f["y"]) if f["y"] is not None else float("inf")
                    for f in self.figures), default=float("inf"))
        rng = np.random.default_rng([self.ctx.seed % 2**63, 13])
        n = min(int(self.t["sample_figures"]), len(self.figures))
        sample = sorted(rng.choice(len(self.figures), size=n, replace=False).tolist())
        tiles, expected = new_tiles(), {}
        for i in sample:
            f = self.figures[i]
            if not os.path.exists(f["png"]):
                tiles["tiles_missing"] += 1
                continue
            if f["wav"] not in expected:
                sig, rate = signals[f["wav"]]
                expected[f["wav"]] = ref_mel.figure(sig, rate, frame, hop, n_mels, spec[f["wav"]])
            add(tiles, judge.judge(judge.decode(f["png"]), expected[f["wav"]], text))
        self.ctx.log(f"[check] figures_judged={tiles['judged']} figures_rows_compared={len(with_rows)} "
                     f"pixels_compared={tiles['compared']}")
        checks = [at_most("figures_missing", missing, 0),
                  *judged_checks(self.t["limits"], worst, len(with_rows), axis, tiles)]
        if self.ctx.cuda:
            checks.append(at_least("percentile_quantize_launches", self.launches, 1))
        return checks


def judged_checks(lim: dict, worst: float, rows_compared: int, axis: float, tiles: dict) -> list[dict]:
    """The numbers compared with the reference, each beside its limit: a run's and the control's alike."""
    off_pct = 100.0 * tiles["off"] / tiles["compared"] if tiles["compared"] else 100.0
    return [
        at_least("figures_rows_compared", rows_compared, 1),
        at_most("mel_err_ratio", worst, lim["mel_err_ratio"]),
        at_most("mel_centres_rel_err", axis, lim["mel_centres_rel_err"]),
        at_least("figures_judged", tiles["judged"], 1),
        at_most("tiles_missing", tiles["tiles_missing"], 0),
        at_most("tile_pixels_off_pct", off_pct, lim["tile_pixels_off_pct"]),
        at_most("tile_max_bins_off", tiles["max_gap"], lim["tile_max_bins_off"]),
    ]


def control(seed: int, traffic: dict, root) -> list[dict]:
    """The cell's comparison with :mod:`reference.lower_mel` in the port's place: the mel power in bfloat16.

    Each recording's mel rows drawn from the seed, its bfloat16 mel centres,
    and the figures painted from the control's full mel power, judged as a
    run judges the port's, with the cell's limits.
    """
    import tempfile

    from reference import lower, lower_mel

    text = layout.Text(str(root / layout.FONT))
    frame, hop, n_mels = shape(traffic)
    rate, seconds = int(traffic["rate"]), float(traffic["seconds"])
    rows = sample_rows(seed, traffic)
    axis = ref_mel.centres_rel_err(ref_mel.centres(n_mels, rate), lower_mel.bf16_centres(n_mels, rate))
    worst, tiles, count = 0.0, new_tiles(), int(traffic["recordings"])
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(count):
            path = os.path.join(tmp, f"r{i}.wav")
            gen_audio.write_wav(path, gen_audio.recording(seed, i, seconds, rate), rate)
            sig, rate = ref_audio.load(path)
            ref = ref_mel.mel_power(sig, rate, frame, hop, n_mels)
            ctl = lower_mel.bf16_mel_power(sig, rate, frame, hop, n_mels)
            worst = max(worst, ref_audio.err_ratio(ref[rows], ctl[rows]))
            if i < int(traffic["sample_figures"]):
                painted = lower.painted(ref_mel.figure(sig, rate, frame, hop, n_mels, ctl), text)
                add(tiles, judge.judge(painted, ref_mel.figure(sig, rate, frame, hop, n_mels, ref), text))
    return judged_checks(traffic["limits"], worst, count, axis, tiles)
