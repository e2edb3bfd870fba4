"""The FAST pitch-grid slice through the port, end to end, on the CPU.

One small synthetic orbit (A = 16) goes through the extrema pre-pass and
``FAST_process_single_orbit`` of both packages; the PNG files must decode
to identical pixels on the host backend and agree within one colormap bin
on the device backend.  The golden pitch grid must come out of the port pixel
for pixel.  And the port must import and run the slice, the audio CLI,
the generic batch, the flagship batch CLI and the collective extrema of
``parallel`` (in a one-rank group) with ``jax`` (and ``matplotlib``)
blocked.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "goldens" / "fast_pitch_grid_200dpi.png"
INSTRUMENTS = ("ees", "eeb", "ies", "ieb")

torch.set_num_threads(1)


def _pngs(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.png"))}


@pytest.fixture(scope="module")
def orbit_archive(tmp_path_factory):
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("torch_slice")
    mapping = synth_fast_archive(str(root / "data"), [4100], n_time=160, n_angle=16, n_energy=24,
                                 cusp_csv_path=str(root / "cusp.tsv"), seed=3)
    return {"root": root, "mapping": mapping}


def _pixels(png: bytes) -> np.ndarray:
    import io

    from PIL import Image

    with Image.open(io.BytesIO(png)) as img:
        return np.asarray(img.convert("RGB"))


def _assert_same_pixels(png_a: bytes, png_b: bytes, path: str) -> None:
    """The two PNG files decode to the same image.

    The packages' encoders need not write the same bytes: the port's copy
    of the encoder runs its run-length path in every build, the JAX
    package's only where it links libdeflate (else zlib's deflate, or PIL
    where nothing builds).
    """
    a, b = _pixels(png_a), _pixels(png_b)
    assert a.shape == b.shape and np.array_equal(a, b), path


def _assert_same_or_one_bin_apart(png_a: bytes, png_b: bytes, path: str) -> None:
    """Identical pixels, or pixels that differ only by one colormap bin.

    The device backends of the two packages take float32 ``log10`` from two
    libraries (XLA's and torch's), which disagree in the last ulp on a few
    inputs; a cell sitting on a bin boundary then lands one bin apart (the
    ``+-1`` rule of docs/parity.md:110-126, proven cell by cell against the
    float64 recomputation in tests/test_torch_spectrogram.py).  Such a cell
    shows as data-tile pixels whose two colours are adjacent entries of the
    colormap; every other pixel must match.
    """
    if png_a == png_b:
        return
    from configurable_spectrograms_torch.ops._colormap_data import colormap_lut

    a = _pixels(png_a).astype(np.int64)
    b = _pixels(png_b).astype(np.int64)
    assert a.shape == b.shape, path
    diff = (a != b).any(axis=-1)
    lut = colormap_lut("inferno")[:, :3].astype(np.int64)
    code = {int(c): i for i, c in enumerate(lut[:, 0] << 16 | lut[:, 1] << 8 | lut[:, 2])}
    ia = [code.get(int(c), -9) for c in (a[diff][:, 0] << 16 | a[diff][:, 1] << 8 | a[diff][:, 2])]
    ib = [code.get(int(c), -99) for c in (b[diff][:, 0] << 16 | b[diff][:, 1] << 8 | b[diff][:, 2])]
    assert all(abs(x - y) == 1 for x, y in zip(ia, ib)), f"{path}: pixels differ by more than one bin"


@pytest.mark.parametrize("backend", ["device", "host"])
def test_slice_writes_the_same_pngs_as_the_jax_package(orbit_archive, backend, monkeypatch):
    """Extrema pass + log/log orbit render through both packages.

    Each package encodes with its own native PNG writer, so the files are
    compared decoded.  The host backends must write identical pixels; the
    device backends identical pixels or pixels one colormap bin apart (see
    :func:`_assert_same_or_one_bin_apart`).
    """
    from configurable_spectrograms_tpu.data.cdf_utils import load_filtered_orbits as jax_cusp
    from configurable_spectrograms_tpu.fast.extrema import compute_global_extrema as jax_extrema
    from configurable_spectrograms_tpu.fast.process_orbit import FAST_process_single_orbit as jax_orbit

    from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_torch.fast.extrema import compute_global_extrema
    from configurable_spectrograms_torch.fast.process_orbit import FAST_process_single_orbit
    from configurable_spectrograms_torch.ops import kernels

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    root, mapping = orbit_archive["root"], orbit_archive["mapping"]
    csv = str(root / "cusp.tsv")
    out = {}
    for name, extrema_fn, orbit_fn, cusp in (
        ("jax", jax_extrema, jax_orbit, jax_cusp),
        ("torch", compute_global_extrema, FAST_process_single_orbit, load_filtered_orbits),
    ):
        ex = extrema_fn(str(root / "data"), "log", "log", INSTRUMENTS,
                        extrema_json_path=str(root / f"{name}_{backend}.json"))
        res = orbit_fn(4100, mapping[4100], cusp(csv), 6.25, "log", "log", INSTRUMENTS, "inferno",
                       str(root / f"{name}_{backend}"), global_extrema=ex)
        assert res["status"] == "ok", res
        out[name] = _pngs(root / f"{name}_{backend}")
    assert len(out["torch"]) == 10  # 4 instruments x given/raw pitch grids + 2 instrument grids
    assert list(out["torch"]) == list(out["jax"])
    for path in out["jax"]:
        if backend == "host":
            _assert_same_pixels(out["torch"][path], out["jax"][path], path)
        else:
            _assert_same_or_one_bin_apart(out["torch"][path], out["jax"][path], path)
    assert kernels.LAUNCHES == {"collapse": 0, "fused_quantize": 0, "stft_power": 0,
                                "percentile_quantize": 0}  # CPU tensors launch nothing


@pytest.mark.parametrize("backend", ["host", "device"])
def test_golden_pitch_grid_through_the_port(backend, tmp_path, monkeypatch):
    """tests/goldens/fast_pitch_grid_200dpi.png, pixel for pixel, rendered by the port."""
    from PIL import Image

    from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive
    from configurable_spectrograms_torch.fast.plotting import FAST_plot_pitch_angle_grid

    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("CST_RENDER_BACKEND", backend)
    mapping = synth_fast_archive(str(tmp_path), [4242], n_time=120, n_angle=12, n_energy=24,
                                 cusp_csv_path=str(tmp_path / "cusp.tsv"), seed=7)
    fig, _ = FAST_plot_pitch_angle_grid(
        mapping[4242]["ees"], filtered_orbits_df=load_filtered_orbits(str(tmp_path / "cusp.tsv")),
        orbit_number=4242, scale_function_y="log", scale_function_z="log", show=False, colormap="inferno",
    )
    img = np.asarray(fig.render(dpi=200).convert("RGB"))
    golden = np.asarray(Image.open(GOLDEN).convert("RGB"))
    assert img.shape == golden.shape
    assert not (img != golden).any(axis=-1).any(), f"{(img != golden).any(axis=-1).mean():.4%} of pixels differ"


#: A meta-path hook that makes ``jax``, ``jaxlib``, the JAX package and
#: matplotlib fail to import: the head of every blocked-import run.
BLOCK_JAX = textwrap.dedent(
    """
    import importlib, importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "configurable_spectrograms_tpu", "matplotlib"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    """
)

_BLOCKED_RUN = BLOCK_JAX + textwrap.dedent(
    """
    import os, pkgutil, wave

    import configurable_spectrograms_torch as pkg

    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(mod.name)

    from configurable_spectrograms_torch.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_torch.data.synthetic import synth_fast_archive
    from configurable_spectrograms_torch.fast.extrema import compute_global_extrema
    from configurable_spectrograms_torch.fast.process_orbit import FAST_process_single_orbit

    tmp = sys.argv[1]
    m = synth_fast_archive(tmp + "/data", [7], n_time=64, n_angle=8, n_energy=16, cusp_csv_path=tmp + "/c.tsv")
    insts = ("ees", "eeb", "ies", "ieb")
    ex = compute_global_extrema(tmp + "/data", "log", "log", insts, extrema_json_path=tmp + "/x.json")
    r = FAST_process_single_orbit(7, m[7], load_filtered_orbits(tmp + "/c.tsv"), 6.25, "log", "log", insts,
                                  "inferno", tmp + "/plots", global_extrema=ex)
    assert r["status"] == "ok", r
    print("PNGS", sum(len(f) for _, _, f in os.walk(tmp + "/plots")))

    import numpy as np
    from configurable_spectrograms_torch.cli import audio
    from configurable_spectrograms_torch.data.cdf_utils import load_fast_cdf_dataset
    from configurable_spectrograms_torch.generic_batch import generic_batch_plot

    with wave.open(tmp + "/a.wav", "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes((np.sin(np.arange(8000) * 0.3) * 9000).astype("<i2").tobytes())
    sys.argv = ["audio", "--wav-file", tmp + "/a.wav", "--output", tmp + "/a.png", "--stft-method", "pallas",
                "--frame-length", "256", "--hop-length", "64", "--n-mels", "16"]
    assert audio.main() == 0 and os.path.exists(tmp + "/a.png")

    def build(inst):
        d = load_fast_cdf_dataset(m[7][inst])
        return [{"x": d["times"], "y": d["energy"], "data": d["data"], "label": inst}]

    res = generic_batch_plot(list(insts), tmp + "/generic", build, progress_json_path=tmp + "/g.json",
                             install_signal_handlers=False)
    assert dict(res) == {i: "ok" for i in insts}, res
    assert not any(k.split(".")[0] in ("jax", "jaxlib", "configurable_spectrograms_tpu") for k in sys.modules)
    print("GENERIC", sum(len(f) for _, _, f in os.walk(tmp + "/generic")))

    # The flagless flagship CLI in a ./FAST_data + ./FAST_Cusp_Indices.csv working directory, one combo.
    import functools, shutil
    from configurable_spectrograms_torch.cli import batch_multi_plot_FAST_spectrograms as flagship
    from configurable_spectrograms_torch.utils.config import FastBatchConfig, ScaleCombo
    from configurable_spectrograms_torch.utils.logging import set_logfile_path

    shutil.copytree(tmp + "/data", tmp + "/cwd/FAST_data")
    shutil.copy(tmp + "/c.tsv", tmp + "/cwd/FAST_Cusp_Indices.csv")
    os.chdir(tmp + "/cwd")
    flagship.FastBatchConfig = functools.partial(FastBatchConfig, combos=(ScaleCombo("log", "log", "inferno"),))
    flagship.main()
    set_logfile_path(None)
    assert not any(k.split(".")[0] in ("jax", "jaxlib", "configurable_spectrograms_tpu", "matplotlib")
                   for k in sys.modules)
    from configurable_spectrograms_torch.render import text
    assert text._font_path() == text.BUNDLED_FONT
    print("FLAGSHIP", sum(len(f) for _, _, f in os.walk("FAST_plots")))

    # The parallel layer and the entry points: the collective extrema in a one-rank group.
    import socket
    import configurable_spectrograms_torch.entry
    import configurable_spectrograms_torch.parallel
    from configurable_spectrograms_torch.ops.extrema_ops import batched_file_stats
    from configurable_spectrograms_torch.parallel import make_mesh, sharded_extrema_stats
    from configurable_spectrograms_torch.parallel.mesh import init_distributed, shutdown_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        cubes = (np.random.default_rng(0).random((2, 16, 4, 8)) * 9).astype(np.float32)
        counts, hist = sharded_extrema_stats(cubes, np.array([16, 11], np.int32), make_mesh(1))
    finally:
        shutdown_distributed()
    ref = batched_file_stats([cubes[0], cubes[1, :11]])
    assert (counts == np.stack([r["counts"] for r in ref])).all()
    assert (hist == np.sum([r["hist"] for r in ref], axis=0)).all()
    assert not any(k.split(".")[0] in ("jax", "jaxlib", "configurable_spectrograms_tpu") for k in sys.modules)
    print("PARALLEL", int(hist.sum()))
    """
)


def test_port_imports_and_runs_the_slice_with_jax_blocked(tmp_path):
    env = dict(os.environ, CST_TORCH_DEVICE="cpu", CST_RENDER_BACKEND="device", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PNGS 10" in proc.stdout
    assert "GENERIC 4" in proc.stdout
    assert "FLAGSHIP 10" in proc.stdout  # 4 instruments x given/raw pitch grids + 2 instrument grids
    assert "PARALLEL " in proc.stdout and "PARALLEL 0" not in proc.stdout
