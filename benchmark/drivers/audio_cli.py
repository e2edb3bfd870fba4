"""The audio CLI on short clips: one user rendering figures one after another (a closed loop).

Set-up writes the cell's recordings from the seed (child processes,
under ``TMPDIR``), imports the port, loads its PNG encoder, and warms up
with one figure.  The window renders the recordings in turn, cycling,
through ``cli.audio.render_audio_spectrogram`` with the CLI's defaults
(the device back end), each figure to a PNG of its own, until the
window's seconds are reached; the figure running then is finished.  A new
load makes new host arrays, so no cache of the port serves one figure from
another.  ``audio_figure_s`` is the window's seconds over its figures.

Afterwards every figure's PNG must exist; figures drawn from the seed have
their tiles, and the window's first figure and a share of the others drawn
from the seed the rows of their power spectrogram drawn from the seed,
held to :mod:`reference.audio`.
"""

from __future__ import annotations

import os
import time

import numpy as np

from gen import audio as gen_audio
from harness.checks import at_least, at_most
from reference import audio as ref_audio
from reference import judge, layout

SYNTH_WORKERS = min(8, os.cpu_count() or 1)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.rec = ctx.recorder
        self.figures: list[dict] = []
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

        self.cli = cli_audio
        parts["import_port_s"] = time.perf_counter() - t
        t = time.perf_counter()
        from configurable_spectrograms_torch.render import fastpng

        fastpng.library()
        parts["png_encoder_s"] = time.perf_counter() - t
        self.out = os.path.join(self.ctx.scratch, "figures")
        os.makedirs(self.out)
        n = int(self.t["seconds"] * self.t["rate"])
        frames = ref_audio.frame_starts(n).size
        rng = np.random.default_rng([self.ctx.seed % 2**63, 11])
        self.rows = np.sort(rng.choice(frames, size=min(int(self.t["sample_rows"]), frames), replace=False))
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
            with self.rec.span("stft"):
                ds = real(*a, **kw)
            if keep:
                kept["rows"] = np.array(ds["data"][self.rows, 0, :])
            return ds

        wav = self.wavs[k % len(self.wavs)]
        self.cli.audio_spectrogram_dataset = dataset
        t = time.perf_counter()
        try:
            with self.rec.span("figure"):
                ok = self.cli.render_audio_spectrogram(wav, path)
                if self.ctx.cuda:
                    torch.cuda.synchronize()
        finally:
            self.cli.audio_spectrogram_dataset = real
        fig = {"k": k, "wav": wav, "png": path, "ok": bool(ok), "seconds": time.perf_counter() - t,
               "rows": kept.get("rows")}
        self.figures.append(fig)
        return fig

    def window(self, seconds: float) -> dict:
        from configurable_spectrograms_torch.utils import timing

        if self.ctx.trace:
            self.timer = timing.ACTIVE = timing.StageTimer("benchmark")
        t0 = time.perf_counter()
        k = 0
        while not self.figures or time.perf_counter() - t0 < seconds:
            self._figure(k, os.path.join(self.out, f"figure_{k}.png"))
            k += 1
        elapsed = time.perf_counter() - t0
        timing.ACTIVE = None
        failed = sum(not f["ok"] for f in self.figures)
        log = {"figures": len(self.figures), "seconds": elapsed,
               "figure_s": [round(f["seconds"], 3) for f in self.figures]}
        return {"e2e": {"audio_figure_s": elapsed / len(self.figures)}, "attempted": len(self.figures),
                "failed": failed, "log": log, "timer": self.timer}

    def release(self) -> None:
        import gc

        gc.collect()
        if self.ctx.cuda:
            import torch

            torch.cuda.empty_cache()

    def check(self) -> list[dict]:
        missing = sum(not (f["ok"] and os.path.exists(f["png"])) for f in self.figures)
        text = layout.Text(str(self.ctx.root / layout.FONT))
        signals = {}
        for f in self.figures:
            if f["wav"] not in signals:
                signals[f["wav"]] = ref_audio.load(f["wav"])
        rows_ref = {w: ref_audio.power(sig, self.rows) for w, (sig, _) in signals.items()}
        with_rows = [f for f in self.figures if f["rows"] is not None]
        worst = max((ref_audio.err_ratio(rows_ref[f["wav"]], f["rows"]) for f in with_rows), default=0.0)
        rng = np.random.default_rng([self.ctx.seed % 2**63, 13])
        n = min(int(self.t["sample_figures"]), len(self.figures))
        sample = sorted(rng.choice(len(self.figures), size=n, replace=False).tolist())
        tiles = new_tiles()
        for i in sample:
            f = self.figures[i]
            if not os.path.exists(f["png"]):
                tiles["tiles_missing"] += 1
                continue
            sig, rate = signals[f["wav"]]
            add(tiles, judge.judge(judge.decode(f["png"]), ref_audio.figure(sig, rate), text))
        self.ctx.log(f"[check] figures_judged={tiles['judged']} figures_rows_compared={len(with_rows)} "
                     f"pixels_compared={tiles['compared']}")
        return [at_most("figures_missing", missing, 0), *judged_checks(self.t["limits"], worst, len(with_rows), tiles)]


def new_tiles() -> dict:
    return {"judged": 0, "compared": 0, "off": 0, "max_gap": 0, "tiles_missing": 0}


def add(tiles: dict, r: dict) -> None:
    tiles["judged"] += 1
    for key in ("compared", "off", "tiles_missing"):
        tiles[key] += r[key]
    tiles["max_gap"] = max(tiles["max_gap"], r["max_gap"])


def judged_checks(lim: dict, worst: float, rows_compared: int, tiles: dict) -> list[dict]:
    """The numbers compared with the reference, each beside its limit: a run's and the control's alike."""
    off_pct = 100.0 * tiles["off"] / tiles["compared"] if tiles["compared"] else 100.0
    return [
        at_least("figures_rows_compared", rows_compared, 1),
        at_most("stft_err_ratio", worst, lim["stft_err_ratio"]),
        at_least("figures_judged", tiles["judged"], 1),
        at_most("tiles_missing", tiles["tiles_missing"], 0),
        at_most("tile_pixels_off_pct", off_pct, lim["tile_pixels_off_pct"]),
        at_most("tile_max_bins_off", tiles["max_gap"], lim["tile_max_bins_off"]),
    ]


def control(seed: int, traffic: dict, root) -> list[dict]:
    """The cell's comparison with :mod:`reference.lower` in the port's place: the power in bfloat16.

    Each recording's power rows drawn from the seed, and the figures
    painted from the control's full power, judged as a run judges the
    port's, with the cell's limits.
    """
    import tempfile

    from reference import lower

    text = layout.Text(str(root / layout.FONT))
    rate, seconds = int(traffic["rate"]), float(traffic["seconds"])
    n_frames = ref_audio.frame_starts(int(seconds * rate)).size
    rng = np.random.default_rng([seed % 2**63, 11])
    rows = np.sort(rng.choice(n_frames, size=min(int(traffic["sample_rows"]), n_frames), replace=False))
    worst, tiles, count = 0.0, new_tiles(), int(traffic["recordings"])
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(count):
            path = os.path.join(tmp, f"r{i}.wav")
            gen_audio.write_wav(path, gen_audio.recording(seed, i, seconds, rate), rate)
            sig, rate = ref_audio.load(path)
            worst = max(worst, ref_audio.err_ratio(ref_audio.power(sig, rows), lower.bf16_power(sig, rows)))
            if i < int(traffic["sample_figures"]):
                add(tiles, judge.judge(lower.painted(ref_audio.figure(sig, rate, lower.bf16_power(sig)), text),
                                       ref_audio.figure(sig, rate), text))
    return judged_checks(traffic["limits"], worst, count, tiles)
