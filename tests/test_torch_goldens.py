"""All eight figure goldens of ``tests/goldens/`` rendered by the port, pixel for pixel, on both backends.

The inputs are those of tests/test_golden_figures.py:24-114 (and :171-189
for the audio figure), made with the port's own copies of the synthetic
data and plotting functions.  The device backend runs on CPU tensors.  One
known exception is asserted rather than skipped: on the device backend the
audio figure's colorbar ticks differ from the golden in both packages (the
1e-10 floor of vmin is float32 on the device, float64 on the host), so there
the port must equal the JAX package's device render, and every pixel that
differs from the golden must lie in the colorbar, right of the data tile.

The bundled font is held here too: with ``matplotlib`` (and ``jax``)
blocked, the port finds its own DejaVuSans.ttf and renders the pitch-grid
golden pixel for pixel.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
GOLDEN_DIR = REPO / "tests" / "goldens"

torch.set_num_threads(1)


def _dataset(n_time=90, n_angle=6, n_energy=20):
    from configurable_spectrograms_torch.data.synthetic import synth_instrument_arrays

    return synth_instrument_arrays(np.random.default_rng(42), n_time=n_time, n_angle=n_angle, n_energy=n_energy)


def _multirow(y_scale="log", z_scale="log", colormap="inferno"):
    from configurable_spectrograms_torch.render.plotting import generic_plot_multirow_optional_zoom

    a = _dataset()
    ds = [
        {"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"], "label": "EES"},
        {"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"] * 3.0, "label": "IES"},
    ]
    marks = [float(a["time_unix"][35]), float(a["time_unix"][55])]
    fig, _ = generic_plot_multirow_optional_zoom(ds, vertical_lines=marks, y_scale=y_scale, z_scale=z_scale,
                                                 colormap=colormap, cusp_marker_style="both",
                                                 title="Golden multirow")
    return fig, 60


def _generic_set():
    from configurable_spectrograms_torch.render.plotting import generic_plot_spectrogram_set

    a = _dataset(n_time=70, n_energy=16)
    ds = [{"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"], "label": "Row A"}]
    fig, _ = generic_plot_spectrogram_set(ds, y_scale="linear", z_scale="linear", colormap="viridis",
                                          figure_title="Golden set")
    return fig, 60


def _fast_archive(tmp: Path):
    from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    mapping = synth_fast_archive(str(tmp), [4242], n_time=120, n_angle=12, n_energy=24,
                                 cusp_csv_path=str(tmp / "cusp.tsv"), seed=7)
    return mapping[4242], load_filtered_orbits(str(tmp / "cusp.tsv"))


def _pitch_grid(tmp: Path):
    from configurable_spectrograms_torch.fast.plotting import FAST_plot_pitch_angle_grid

    files, df = _fast_archive(tmp)
    fig, _ = FAST_plot_pitch_angle_grid(files["ees"], filtered_orbits_df=df, orbit_number=4242,
                                        scale_function_y="log", scale_function_z="log", show=False,
                                        colormap="inferno")
    return fig, 200


def _instrument_grid(tmp: Path):
    from configurable_spectrograms_torch.fast.plotting import FAST_plot_instrument_grid

    files, df = _fast_archive(tmp)
    extrema = {}
    for inst in ("ees", "eeb", "ies", "ieb"):
        extrema[f"{inst}_linear_log_y_max"] = 3000
        extrema[f"{inst}_linear_log_z_max"] = 1800.0
    fig, _ = FAST_plot_instrument_grid(files, filtered_orbits_df=df, orbit_number=4242, scale_function_y="linear",
                                       scale_function_z="log", show=False, colormap="plasma",
                                       global_extrema=extrema)
    return fig, 200


def _audio_dataset(monkeypatch):
    """The golden chirp's mel dataset, computed on the host (so only the render backend varies)."""
    from configurable_spectrograms_torch.ops.stft import audio_spectrogram_dataset

    rate = 8000
    t = np.arange(rate) / rate
    sig = np.sin(2 * np.pi * (200 + 1400 * t) * t).astype(np.float32)
    with monkeypatch.context() as m:
        m.setenv("CST_RENDER_BACKEND", "host")
        return audio_spectrogram_dataset(sig, rate, frame_length=256, hop_length=128, n_mels=48,
                                         label="Golden chirp")


_AUDIO_KW = dict(x_is_unix=False, z_scale="log", colormap="magma")


def _audio(ds):
    from configurable_spectrograms_torch.render.plotting import generic_plot_spectrogram_set

    fig, _ = generic_plot_spectrogram_set([ds], **_AUDIO_KW, y_min=float(ds["y"][0]), y_max=float(ds["y"][-1]))
    return fig, 72


_FIGURES = {
    "multirow_zoom_log_log": lambda tmp: _multirow(),
    "multirow_linear_linear": lambda tmp: _multirow("linear", "linear", "viridis"),
    "multirow_linear_log": lambda tmp: _multirow("linear", "log", "cividis"),
    "multirow_log_linear": lambda tmp: _multirow("log", "linear", "plasma"),
    "generic_set_linear": lambda tmp: _generic_set(),
    "fast_pitch_grid_200dpi": _pitch_grid,
    "fast_instrument_grid_200dpi": _instrument_grid,
    "audio_mel_chirp": None,  # built from _audio_dataset (needs monkeypatch)
}


def _rgb(image) -> np.ndarray:
    return np.asarray(image.convert("RGB"))


def _golden(name: str) -> np.ndarray:
    return np.asarray(Image.open(GOLDEN_DIR / f"{name}.png").convert("RGB"))


def test_every_golden_is_covered():
    assert sorted(p.stem for p in GOLDEN_DIR.glob("*.png")) == sorted(_FIGURES)


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("name", sorted(_FIGURES))
def test_golden_through_the_port(name, backend, tmp_path, monkeypatch):
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    if name == "audio_mel_chirp":
        ds = _audio_dataset(monkeypatch)
        fig, dpi = _audio(ds)
    else:
        fig, dpi = _FIGURES[name](tmp_path)
    img = _rgb(fig.render(dpi=dpi))
    golden = _golden(name)
    assert img.shape == golden.shape
    diff = (img != golden).any(axis=-1)
    if name == "audio_mel_chirp" and backend == "device":
        _assert_audio_device_exception(fig, ds, img, diff, monkeypatch)
        return
    assert not diff.any(), f"{diff.mean():.4%} of pixels differ from {name}.png"


def _assert_audio_device_exception(fig, ds, img, diff, monkeypatch) -> None:
    """The known exception: the JAX package's device render exactly, differing from the golden only in the colorbar."""
    from configurable_spectrograms_tpu.render import figure as jfigure
    from configurable_spectrograms_tpu.render.plotting import generic_plot_spectrogram_set as jplot
    from configurable_spectrograms_torch.render.compositor import _Layout

    monkeypatch.setitem(jfigure._BACKEND, "mode", "device")
    monkeypatch.setitem(jfigure._BACKEND, "forced_host", False)
    monkeypatch.setitem(jfigure._BACKEND, "probed", True)
    jfig, _ = jplot([ds], **_AUDIO_KW, y_min=float(ds["y"][0]), y_max=float(ds["y"][-1]))
    assert np.array_equal(img, _rgb(jfig.render(dpi=72)))
    layout = _Layout(fig, 72.0)
    cb_x0 = layout._colorbar_rect(layout.axes_rect(fig.axes[0]))[0]
    ys, xs = np.nonzero(diff)
    assert xs.size > 0 and int(xs.min()) >= cb_x0, "the device audio render differs outside its colorbar"


_FONT_RUN = textwrap.dedent(
    """
    import importlib.abc, os, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("matplotlib", "jax", "jaxlib", "configurable_spectrograms_tpu"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    from PIL import Image

    from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive
    from configurable_spectrograms_torch.fast.plotting import FAST_plot_pitch_angle_grid
    from configurable_spectrograms_torch.render import text

    tmp, golden, pkg = sys.argv[1:4]
    m = synth_fast_archive(tmp, [4242], n_time=120, n_angle=12, n_energy=24, cusp_csv_path=tmp + "/cusp.tsv", seed=7)
    fig, _ = FAST_plot_pitch_angle_grid(m[4242]["ees"], filtered_orbits_df=load_filtered_orbits(tmp + "/cusp.tsv"),
                                        orbit_number=4242, scale_function_y="log", scale_function_z="log",
                                        show=False, colormap="inferno")
    img = np.asarray(fig.render(dpi=200).convert("RGB"))
    want = np.asarray(Image.open(golden).convert("RGB"))
    assert img.shape == want.shape
    assert os.path.commonpath([os.path.realpath(text._font_path()), pkg]) == pkg, text._font_path()
    assert "matplotlib" not in sys.modules
    print("DIFF", int((img != want).any(axis=-1).sum()))
    """
)


def test_bundled_font_renders_the_golden_with_matplotlib_blocked(tmp_path):
    pkg = os.path.realpath(REPO / "configurable_spectrograms_torch")
    env = dict(os.environ, CST_TORCH_DEVICE="cpu", CST_RENDER_BACKEND="host", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _FONT_RUN, str(tmp_path),
                           str(GOLDEN_DIR / "fast_pitch_grid_200dpi.png"), pkg],
                          capture_output=True, text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DIFF 0" in proc.stdout


def test_font_path_is_the_bundled_font():
    from configurable_spectrograms_torch.render import text

    path = text._font_path()
    assert path == text.BUNDLED_FONT and os.path.getsize(path) == 756072
    assert os.path.exists(os.path.join(os.path.dirname(path), "LICENSE_DEJAVU"))
