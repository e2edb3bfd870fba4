"""The flagship CLI over a FAST ESA L2 archive: whole passes of ``main()``, back to back.

Set-up writes the cell's archive from the seed (child processes, under
``TMPDIR``), imports the port, loads its kernel library and PNG encoder,
and warms up with one pass over the first orbit's first file.  A pass is
the flagless ``batch_multi_plot_FAST_spectrograms`` ``main()`` with its
defaults (the extrema pre-pass, then 4 scale combos orbit-major, 4 worker
threads, 200 DPI, the device back end) in a fresh working directory whose
``FAST_data`` holds hard links to the archive at new paths.  Once the
pass's last pre-pass call returns, the port's dataset cache is dropped, so
the render starts cold as it does after a pre-pass over a real archive of
thousands of files.  Passes run until the window's seconds are reached;
the pass running then is finished.  The rate is every panel of the PNGs
the passes wrote over the passes' seconds.

Afterwards every PNG name of every pass, each pass's extrema JSON, and the
tiles of PNGs drawn from the seed are held to :mod:`reference.fast`.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time

import numpy as np

from gen import fast_archive
from harness.checks import at_least, at_most
from reference import fast as ref_fast
from reference import judge, layout

SYNTH_WORKERS = min(8, os.cpu_count() or 1)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.rec = ctx.recorder
        self.passes: list[dict] = []
        self.launch_lanes: dict[str, list] = {"collapse": [], "fused_quantize": []}
        self.timer = None

    # -- set-up -------------------------------------------------------------------

    def setup(self) -> dict[str, float]:
        parts = {}
        os.environ["CST_RENDER_BACKEND"] = "device"
        os.environ.pop("CST_BATCH_SCHEDULE", None)
        t = time.perf_counter()
        self.archive_root = os.path.join(self.ctx.scratch, "archive")
        archive = fast_archive.write_archive(self.archive_root, self.ctx.seed, self.t, SYNTH_WORKERS)
        self.files, self.cusp_csv = archive["files"], archive["cusp_csv"]
        parts["synthesis_s"] = time.perf_counter() - t
        parts["archive_bytes"] = float(archive["bytes"])

        t = time.perf_counter()
        from configurable_spectrograms_torch.cli import batch_multi_plot_FAST_spectrograms as flagship
        from configurable_spectrograms_torch.data import cdf_utils
        from configurable_spectrograms_torch.fast import batch_directory
        from configurable_spectrograms_torch.fast import extrema as fast_extrema
        from configurable_spectrograms_torch.ops import kernels
        from configurable_spectrograms_torch.render import device_cache

        self.flagship, self.cdf_utils, self.batch_directory = flagship, cdf_utils, batch_directory
        self.fast_extrema, self.kernels, self.device_cache = fast_extrema, kernels, device_cache
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

        t = time.perf_counter()
        self._warm_up(sorted(self.files)[0])
        parts["warmup_s"] = time.perf_counter() - t
        return parts

    def _warm_up(self, path: str) -> None:
        """One file's pre-pass and one combo's figures (both kernels, the encoder, the fonts), then cold caches."""
        from configurable_spectrograms_torch.fast.process_orbit import FAST_process_single_orbit

        cwd = os.path.join(self.ctx.scratch, "warmup")
        data = os.path.join(cwd, "FAST_data")
        fast_archive.link_archive([path], self.archive_root, data)
        inst = next(i for i in fast_archive.INSTRUMENTS if f"_{i}_" in os.path.basename(path))
        orbit = int(os.path.basename(path).split("_")[-2])
        linked = os.path.join(data, os.path.relpath(path, self.archive_root))
        extrema_json = os.path.join(cwd, "extrema.json")
        for z_scale in ("linear", "log"):
            ext = self.fast_extrema.compute_global_extrema(data, "linear", z_scale, (inst,),
                                                           extrema_json_path=extrema_json, max_percentile=99.0)
        frame = self.cdf_utils.load_filtered_orbits(self.cusp_csv)
        FAST_process_single_orbit(orbit, {inst: linked}, frame, 6.0, "linear", "log", (inst,), "cividis",
                                  os.path.join(cwd, "FAST_plots"), 60, 30, ext, True)
        self.cdf_utils.clear_dataset_cache()
        shutil.rmtree(cwd)

    # -- the window ---------------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        from configurable_spectrograms_torch.utils import timing

        if self.ctx.trace:
            self.timer = timing.ACTIVE = timing.StageTimer("benchmark")
            self._wrap_kernels()
        launches0 = dict(self.kernels.LAUNCHES)
        dispatches0 = self.device_cache.upload_telemetry()["dispatches"]
        t0 = time.perf_counter()
        k = 0
        while not self.passes or time.perf_counter() - t0 < seconds:
            self.passes.append(self._pass(f"pass_{k}", self.files))
            k += 1
        elapsed = time.perf_counter() - t0
        timing.ACTIVE = None
        self.launches = {n: self.kernels.LAUNCHES[n] - launches0[n] for n in launches0}
        self.dispatches = self.device_cache.upload_telemetry()["dispatches"] - dispatches0
        panels = sum(p["panels"] for p in self.passes)
        expected = len(self.passes) * self.pngs_per_pass
        written = sum(p["pngs"] for p in self.passes)
        failed = sum(p["not_ok"] for p in self.passes) + max(0, expected - written)
        log = {"passes": len(self.passes), "seconds": elapsed, "panels": panels,
               "panels_per_s": panels / elapsed,
               "pass_s": [round(p["seconds"], 3) for p in self.passes],
               "prepass_s": [round(p["prepass_s"], 3) for p in self.passes],
               "decodes": [p["decodes"] for p in self.passes], "launches": self.launches,
               "dispatches": self.dispatches}
        return {"e2e": {"archive_panels_per_s": panels / elapsed}, "attempted": expected, "failed": failed,
                "log": log, "passes": self.passes, "launch_lanes": self.launch_lanes, "timer": self.timer}

    @property
    def pngs_per_pass(self) -> int:
        return int(self.t["orbits"]) * len(ref_fast.COMBOS) * 10

    def _pass(self, name: str, files: list[str]) -> dict:
        """One run of the flagship's ``main()`` over hard links to *files*; what it did and wrote."""
        import signal

        import torch

        cwd = os.path.join(self.ctx.scratch, name)
        fast_archive.link_archive(files, self.archive_root, os.path.join(cwd, "FAST_data"))
        shutil.copy(self.cusp_csv, os.path.join(cwd, "FAST_Cusp_Indices.csv"))
        flagship, cdf_utils, bd = self.flagship, self.cdf_utils, self.batch_directory
        results, prepass = [], {"calls": 0, "seconds": 0.0}
        real_config, real_extrema, real_stats = flagship.FastBatchConfig, bd.compute_global_extrema, \
            self.fast_extrema.batched_file_stats
        n_combos = len(real_config().combos)
        rec = self.rec

        class Recorded(real_config):  # main() drops the driver's results; keep them
            def run(self):
                results.extend(super().run())
                return results

        def extrema(*a, **k):
            t = time.perf_counter()
            try:
                with rec.span("prepass"):
                    return real_extrema(*a, **k)
            finally:
                prepass["seconds"] += time.perf_counter() - t
                prepass["calls"] += 1
                if prepass["calls"] == n_combos:  # the pre-pass is over: the render starts cold
                    cdf_utils.clear_dataset_cache()

        def file_stats(cubes):
            rec.add("prepass_uploads", len(cubes))
            return real_stats(cubes)

        handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
        cdf_utils.filtered_orbits_cache.clear()  # keyed by the cwd-relative default path
        stats0 = cdf_utils.dataset_cache_stats()
        tele0 = self.device_cache.upload_telemetry()
        uploads0 = rec.counters.get("prepass_uploads", 0)
        here = os.getcwd()
        os.chdir(cwd)
        flagship.FastBatchConfig, bd.compute_global_extrema = Recorded, extrema
        self.fast_extrema.batched_file_stats = file_stats
        t0 = time.perf_counter()
        try:
            with rec.span("pass"):
                flagship.main()
                if self.ctx.cuda:
                    torch.cuda.synchronize()
        finally:
            seconds = time.perf_counter() - t0
            flagship.FastBatchConfig, bd.compute_global_extrema = real_config, real_extrema
            self.fast_extrema.batched_file_stats = real_stats
            from configurable_spectrograms_torch.utils.logging import flush_log_buffer, set_logfile_path

            flush_log_buffer()
            set_logfile_path(None)
            os.chdir(here)
            for s, h in handlers.items():  # the driver installs its interrupt escalation
                signal.signal(s, h)
        cdf_utils.clear_dataset_cache()
        pngs = glob.glob(os.path.join(cwd, "FAST_plots", "**", "*.png"), recursive=True)
        stats, tele = cdf_utils.dataset_cache_stats(), self.device_cache.upload_telemetry()
        return {"dir": cwd, "seconds": seconds, "prepass_s": prepass["seconds"], "files": len(files),
                "pngs": len(pngs), "panels": ref_fast.FIGURE_PANELS * len(pngs),
                "not_ok": sum(r.get("status") != "ok" for r in results),
                "decodes": stats["misses"] - stats0["misses"],
                "uploads": tele["cube_misses"] - tele0["cube_misses"]
                + rec.counters.get("prepass_uploads", 0) - uploads0}

    def _wrap_kernels(self) -> None:
        """Keep each collapse and fused launch's shape and lane tensors (traced runs only).

        The tensors stay on the device until the window has closed; the bytes
        their work needs are counted from them then, so no launch waits for a
        copy back inside the traced window.
        """
        from configurable_spectrograms_torch.ops import extrema_ops, spectrogram
        from configurable_spectrograms_torch.render import dispatch

        K, kept = self.kernels, self.launch_lanes
        real_collapse, real_fused = K.collapse_lanes, K.fused_quantize_lanes

        def collapse(cubes, u_idx, masks, t_valid):
            kept["collapse"].append((tuple(cubes.shape), u_idx, masks, t_valid))
            return real_collapse(cubes, u_idx, masks, t_valid)

        def fused(cubes, u_idx, masks, e_valid, t_valid, *rest, **kw):
            kept["fused_quantize"].append((tuple(cubes.shape), u_idx, masks, t_valid))
            return real_fused(cubes, u_idx, masks, e_valid, t_valid, *rest, **kw)

        for module in (K, dispatch, extrema_ops, spectrogram):
            if hasattr(module, "collapse_lanes"):
                module.collapse_lanes = collapse
        for module in (K, dispatch):
            module.fused_quantize_lanes = fused

    # -- after the window ---------------------------------------------------------------

    def release(self) -> None:
        import gc

        self.cdf_utils.clear_dataset_cache()
        gc.collect()
        if self.ctx.cuda:
            import torch

            torch.cuda.empty_cache()

    def check(self) -> list[dict]:
        lim = self.t["limits"]
        files = ref_fast.summaries(self.ctx.seed, self.t, SYNTH_WORKERS)
        ext = ref_fast.extrema(files)
        figures = ref_fast.expected_figures(files, ext)
        missing = tmp_left = extrema_off = 0
        written: list[tuple[str, str]] = []
        for p in self.passes:
            base = os.path.join(p["dir"], "FAST_plots")
            names = {os.path.relpath(f, base) for f in glob.glob(os.path.join(base, "**", "*.png"), recursive=True)}
            missing += len(set(figures) - names) + len(names - set(figures))
            tmp_left += len(glob.glob(os.path.join(base, "**", "*.tmp-*"), recursive=True))
            written += [(base, n) for n in sorted(names & set(figures))]
            try:
                with open(os.path.join(p["dir"], "FAST_calculated_extrema.json")) as f:
                    got = json.load(f)
            except (OSError, json.JSONDecodeError):
                got = {}
            extrema_off += sum(got.get(k) != v for k, v in ext.items())
        text = layout.Text(str(self.ctx.root / layout.FONT))
        tiles = judge_sample(self.ctx.seed, self.t, [n for _, n in written], figures,
                             lambda i: judge.decode(os.path.join(*written[i])), text)
        min_decodes = min(p["decodes"] / p["files"] for p in self.passes)
        checks = [
            at_most("pngs_missing_or_extra", missing, 0),
            at_most("tmp_files_left", tmp_left, 0),
            at_most("orbit_results_not_ok", sum(p["not_ok"] for p in self.passes), 0),
            *judged_checks(lim, extrema_off, tiles),
            at_least("decodes_per_file_min", min_decodes, 1),
        ]
        if self.ctx.cuda:
            checks += [at_least("device_dispatches", self.dispatches, 1),
                       at_least("collapse_launches", self.launches["collapse"], 1),
                       at_least("fused_quantize_launches", self.launches["fused_quantize"], 1)]
        self.ctx.log(f"[check] pngs_judged={tiles['judged']} given_extrema_pngs_judged={tiles['given_named']} "
                     f"holding_the_given_figure={tiles['given_matched']} pixels_compared={tiles['compared']}")
        return checks


def judge_sample(seed: int, traffic: dict, names: list[str], figures: dict, image, text) -> dict:
    """Judge PNGs *names* (``image(i)`` decodes the i-th) in an order drawn from the seed.

    The first ``sample_pngs`` are judged.  A ``given_extrema`` PNG may hold the
    given-extrema figure or the one without extrema (:mod:`reference.fast`);
    only the first puts the quantise with explicit bounds under the
    comparison.  So where none of the sample held it, further
    ``given_extrema`` PNGs are judged, in the same order, until one does (at
    most ``given_extra_pngs`` more).
    """
    order = np.random.default_rng([seed % 2**63, 7]).permutation(len(names))
    n = min(int(traffic["sample_pngs"]), len(names))
    tiles = {"judged": 0, "compared": 0, "off": 0, "max_gap": 0, "tiles_missing": 0 if n else 1,
             "given_named": 0, "given_matched": 0}

    def one(i: int) -> None:
        candidates = figures[names[i]]
        r = judge.best(image(i), candidates, text)
        tiles["judged"] += 1
        for k in ("compared", "off", "tiles_missing"):
            tiles[k] += r[k]
        tiles["max_gap"] = max(tiles["max_gap"], r["max_gap"])
        if len(candidates) == 2:  # a given_extrema PNG whose given figure has panels
            tiles["given_named"] += 1
            tiles["given_matched"] += r["index"] == 0

    for i in order[:n]:
        one(int(i))
    extra = [int(i) for i in order[n:] if len(figures[names[int(i)]]) == 2][: int(traffic["given_extra_pngs"])]
    for i in extra:
        if tiles["given_matched"]:
            break
        one(i)
    return tiles


def judged_checks(lim: dict, extrema_off: int, tiles: dict) -> list[dict]:
    """The numbers compared with the reference, each beside its limit: a run's and the control's alike."""
    off_pct = 100.0 * tiles["off"] / tiles["compared"] if tiles["compared"] else 100.0
    return [
        at_most("extrema_values_off", extrema_off, 0),
        at_most("tiles_missing", tiles["tiles_missing"], 0),
        at_most("tile_pixels_off_pct", off_pct, lim["tile_pixels_off_pct"]),
        at_most("tile_max_bins_off", tiles["max_gap"], lim["tile_max_bins_off"]),
        at_least("given_extrema_figures_judged", tiles["given_matched"], 1),
    ]


def control(seed: int, traffic: dict, root) -> list[dict]:
    """The cell's comparison with :mod:`reference.lower` in the port's place: the pitch sums in bfloat16.

    Every PNG of a pass is painted from the control's figures (a
    ``given_extrema`` name from its given figure) and judged as a run judges
    the port's, with the cell's limits.
    """
    from reference import lower

    files = ref_fast.summaries(seed, traffic, SYNTH_WORKERS)
    ctl = ref_fast.summaries(seed, traffic, SYNTH_WORKERS, collapse=lower.bf16_collapse)
    ext, ext_ctl = ref_fast.extrema(files), ref_fast.extrema(ctl)
    want, got = ref_fast.expected_figures(files, ext), ref_fast.expected_figures(ctl, ext_ctl)
    names = sorted(want)
    text = layout.Text(str(root / layout.FONT))
    tiles = judge_sample(seed, traffic, names, want, lambda i: lower.painted(got[names[i]][0], text), text)
    return judged_checks(traffic["limits"], sum(ext_ctl[k] != v for k, v in ext.items()), tiles)
