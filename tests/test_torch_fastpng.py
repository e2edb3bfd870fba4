"""The port's native PNG encoder, run blit and text blend against numpy, PIL and the JAX package.

The port builds its own copy of ``native/fastpng.cpp``
(``configurable_spectrograms_torch/native/fastpng.cpp``) with g++.  The run
blit must be byte-identical to the port's numpy tail and to the JAX
package's blit on the layouts of tests/test_native_blit.py; the blend equal
to ``Image.paste`` over every (mask, canvas, tile) byte triple; an encoded
PNG must decode to the pixels it was given, and be byte-equal to the JAX
package's encoder on the same array.
"""

import ctypes
import io
import os
import subprocess

import numpy as np
import pytest
from PIL import Image

from configurable_spectrograms_tpu.render import fastpng as jfastpng
from configurable_spectrograms_tpu.render import tile as jtile
from configurable_spectrograms_torch.ops._colormap_data import colormap_lut
from configurable_spectrograms_torch.render import fastpng, tile

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _case(rng, T=70, E=24, H=52, W=96):
    """The random layout of tests/test_native_blit.py."""
    idx = rng.integers(0, 256, (T, E), dtype=np.uint8)
    kept_pos = np.sort(rng.choice(E, size=E - 4, replace=False)).astype(np.int32)
    n_kept = int(rng.integers(1, len(kept_pos) + 1))
    window = tile.TimeWindow(t_start=6, t_count=T - 12, extent=(6.0, float(T - 7)), xlim=(0.0, float(T)))
    return dict(idx=idx, kept_pos=kept_pos, n_kept=n_kept, flip=bool(rng.integers(0, 2)), y0=3.5, y1=18000.0,
                t_start=window.t_start, t_count=window.t_count, x_map=tile.make_x_map(window, W), out_h=H, out_w=W,
                y_scale="log" if rng.integers(0, 2) else "linear", lut=colormap_lut("viridis"))


def _pre_gathered():
    rng = np.random.default_rng(11)
    W, E, H = 64, 16, 30
    window = tile.TimeWindow(t_start=0, t_count=40, extent=(0.0, 39.0), xlim=(0.0, 39.0))
    return dict(idx=rng.integers(0, 256, (W, E), dtype=np.uint8), kept_pos=np.arange(E, dtype=np.int32), n_kept=E,
                flip=True, y0=1.0, y1=100.0, t_start=0, t_count=40, x_map=tile.make_x_map(window, W), out_h=H,
                out_w=W, y_scale="linear", lut=colormap_lut("inferno"), pre_gathered=True)


def _three_ways(monkeypatch, args: dict, out_shape=None, view=None):
    """(native port, numpy tail of the port, JAX native) outputs of resample_indices on *args*."""
    calls = []
    real = fastpng.blit_runs

    def counting(*a):
        calls.append(1)
        return real(*a)

    def run(fn, patch=None):
        with monkeypatch.context() as m:
            if patch:
                patch(m)
            if out_shape is None:
                return fn(**args)
            canvas = np.full(out_shape, 7, np.uint8)
            fn(**args, out=canvas[view])
            return canvas

    native = run(tile.resample_indices, lambda m: m.setattr(fastpng, "blit_runs", counting))
    numpy_tail = run(tile.resample_indices, lambda m: m.setattr(fastpng, "blit_runs", lambda *a: False))
    jax_native = run(jtile.resample_indices)
    assert calls, "the native blit did not run"
    return native, numpy_tail, jax_native


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "seed3", "clipped_view", "pre_gathered"])
def test_blit_matches_numpy_tail_and_jax(case, monkeypatch):
    assert jfastpng.blit_available()
    if case.startswith("seed"):
        outs = _three_ways(monkeypatch, _case(np.random.default_rng(int(case[-1]))))
    elif case == "clipped_view":
        outs = _three_ways(monkeypatch, _case(np.random.default_rng(7), H=40, W=80), (64, 120, 4),
                           (slice(10, 43), slice(5, 77)))
        assert (outs[0][:10] == 7).all() and (outs[0][43:] == 7).all()  # outside the view untouched
    else:
        outs = _three_ways(monkeypatch, _pre_gathered())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_blit_declines_layouts_it_does_not_take():
    t_idx = np.zeros(4, np.int32)
    rest = (np.ones(4, np.uint8), np.zeros(1, np.int32), np.zeros(1, np.int32), np.full(1, 4, np.int32),
            np.zeros((257, 4), np.uint8))
    out = np.zeros((4, 4, 4), np.uint8)
    assert fastpng.blit_runs(np.asfortranarray(np.zeros((8, 8), np.uint8)), t_idx, *rest, out) is False
    assert fastpng.blit_runs(np.zeros((8, 8), np.uint8)[::-1], t_idx, *rest, out) is False
    idx = np.zeros((8, 8), np.uint8)
    assert fastpng.blit_runs(idx, np.full(4, 8, np.int32), *rest, out) is False  # row out of range
    assert fastpng.blit_runs(idx, t_idx, rest[0], np.full(1, 8, np.int32), *rest[2:], out) is False  # column
    assert fastpng.blit_runs(idx, t_idx, *rest, out) is True


def _pil_paste(canvas: np.ndarray, tile_rgba: np.ndarray, x: int, y: int) -> np.ndarray:
    img = Image.fromarray(np.ascontiguousarray(canvas), "RGBA")
    t = Image.fromarray(tile_rgba, "RGBA")
    img.paste(t, (x, y), t)
    return np.asarray(img)


def test_blend_every_byte_triple_equals_image_paste():
    m, v1, v2 = np.meshgrid(*(np.arange(256, dtype=np.uint8),) * 3, indexing="ij")
    canvas = np.stack([v1, v1, v1, v1], axis=-1).reshape(4096, 4096, 4).copy()
    tile_rgba = np.stack([v2, v2, v2, m], axis=-1).reshape(4096, 4096, 4).copy()
    expected = _pil_paste(canvas, tile_rgba, 0, 0)
    assert fastpng.blend_tile(canvas, tile_rgba, 0, 0)
    np.testing.assert_array_equal(canvas, expected)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_canvas_blender_places_and_clips_like_image_paste(seed):
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (48, 72, 4), np.uint8)
    paste = fastpng.canvas_blender(canvas)
    assert paste is not None
    for _ in range(30):
        th, tw = int(rng.integers(1, 24)), int(rng.integers(1, 24))
        tile_rgba = rng.integers(0, 256, (th, tw, 4), np.uint8)
        x, y = int(rng.integers(-tw - 3, 75)), int(rng.integers(-th - 3, 51))
        expected = _pil_paste(canvas, tile_rgba, x, y)
        assert paste(tile_rgba, x, y)
        np.testing.assert_array_equal(canvas, expected)
    tile_rgba = np.zeros((2, 2, 4), np.uint8)
    assert not paste(tile_rgba.astype(np.int16), 0, 0)
    assert not paste(tile_rgba[:, :, :3], 0, 0)
    assert not paste(tile_rgba[:, ::-1], 0, 0)


def test_blend_into_strided_rows_and_declines():
    rng = np.random.default_rng(7)
    full = rng.integers(0, 256, (32, 48, 4), np.uint8)
    tile_rgba = rng.integers(0, 256, (8, 8, 4), np.uint8)
    view = full[:, 4:40]
    expected = _pil_paste(view, tile_rgba, 3, 5)
    assert fastpng.blend_tile(view, tile_rgba, 3, 5)
    np.testing.assert_array_equal(view, expected)
    canvas = np.zeros((8, 8, 4), np.uint8)
    assert not fastpng.blend_tile(canvas[::-1], tile_rgba, 0, 0)
    assert not fastpng.blend_tile(canvas.astype(np.int16), tile_rgba, 0, 0)
    assert fastpng.canvas_blender(np.zeros((8, 8, 3), np.uint8)) is None
    assert fastpng.canvas_blender(canvas[::-1]) is None


def test_blend_probe_and_route():
    lib = fastpng.library()
    assert fastpng._blend_matches_pillow(lib.fastpng_blend_tile)
    assert not fastpng._blend_matches_pillow(lambda *a: 0)  # a blend that writes nothing
    assert fastpng.blend_route() == "native"


def test_text_pastes_through_the_blend_when_native(monkeypatch):
    """A compositor canvas pastes its text through the kernel, and through Image.paste when the probe says no."""
    from configurable_spectrograms_torch.render import text

    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (40, 60, 4), np.uint8)
    tile_img = Image.fromarray(rng.integers(0, 256, (9, 13, 4), np.uint8), "RGBA")
    out = {}
    for route in ("native", "Image.paste"):
        monkeypatch.setattr(fastpng, "_BLEND_OK", [route == "native"])
        arr = base.copy()
        canvas = Image.frombuffer("RGBA", (60, 40), arr, "raw", "RGBA", 0, 1)
        canvas.readonly = 0
        canvas._np_canvas = arr
        text._paste_tile(canvas, tile_img, 17, -3)
        assert (canvas._blend_paste is not None) == (route == "native")
        out[route] = arr
    np.testing.assert_array_equal(out["native"], out["Image.paste"])
    np.testing.assert_array_equal(out["native"], _pil_paste(base, np.asarray(tile_img), 17, -3))


@pytest.mark.parametrize("name", sorted(p[:-4] for p in os.listdir(GOLDENS) if p.endswith(".png")))
def test_encoded_golden_canvases_decode_to_their_pixels(name, tmp_path):
    rgb = np.asarray(Image.open(os.path.join(GOLDENS, f"{name}.png")).convert("RGB"))
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 77, np.uint8)], axis=-1)
    for arr, fname in ((rgb, "rgb.png"), (rgba, "rgba.png")):
        out = str(tmp_path / fname)
        fastpng.write_png_rgb(arr, out, 3)
        with Image.open(out) as img:
            assert img.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(img), rgb)


@pytest.mark.parametrize("kind", ["golden_canvas", "noise"])
def test_encoder_bytes_equal_the_jax_packages(kind, tmp_path):
    """The same array through both packages' encoders (the same source, the same variant): the same bytes."""
    if kind == "noise":  # noise routes to the deflate path, a canvas to the run encoder
        arr = np.random.default_rng(5).integers(0, 256, (300, 400, 4), np.uint8)
    else:
        arr = np.asarray(Image.open(os.path.join(GOLDENS, "fast_pitch_grid_200dpi.png")).convert("RGB"))
    mine, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    fastpng.write_png_rgb(arr, str(mine), 3)
    assert jfastpng.write_png_rgb(arr, str(theirs), 3)
    assert mine.read_bytes() == theirs.read_bytes()
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(arr[..., :3])).save(buf, format="PNG", compress_level=3)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(buf.getvalue()))), np.asarray(Image.open(mine)))


def test_write_png_rgb_raises_instead_of_falling_back(tmp_path):
    with pytest.raises(ValueError):
        fastpng.write_png_rgb(np.zeros((4, 4), np.uint8), str(tmp_path / "a.png"))
    with pytest.raises(ValueError):
        fastpng.write_png_rgb(np.zeros((4, 4, 2), np.uint8), str(tmp_path / "a.png"))
    with pytest.raises(OSError):
        fastpng.write_png_rgb(np.zeros((4, 4, 3), np.uint8), str(tmp_path / "no" / "dir" / "a.png"))


def test_build_info_names_the_variant_and_the_library():
    from configurable_spectrograms_torch.ops._build import BUILD_DIR

    fastpng.library()
    variant = {0: "zlib", 1: "libdeflate", 2: "zlib-abi"}[fastpng.library().fastpng_variant()]
    assert fastpng.BUILD_INFO["variant"] == variant
    assert [name for name, _ in fastpng._variants()][::3] == ["libdeflate", "zlib", "zlib-abi"]  # the order tried
    path = fastpng.BUILD_INFO["path"]
    assert os.path.dirname(path) == str(BUILD_DIR) and os.path.basename(path) == fastpng.library_path().name
    assert fastpng._host_tag() in path


def test_zlib_abi_variant_builds_without_headers_and_encodes(tmp_path):
    """The variant for a host without libdeflate's or zlib's header: zlib's ABI declared in the source.

    A figure canvas goes through the run encoder in every variant, so its
    bytes equal the libdeflate build's.
    """
    name, flags = fastpng._variants()[-1]
    assert name == "zlib-abi"
    deps = subprocess.run(["g++", "-M", "-DFASTPNG_ZLIB_ABI", str(fastpng.SRC)], check=True, capture_output=True,
                          text=True, timeout=180).stdout
    assert "zlib.h" not in deps and "libdeflate.h" not in deps
    lib_path = tmp_path / "libabi.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-o", str(lib_path), str(fastpng.SRC), *flags],
                   check=True, capture_output=True, timeout=180)
    lib = ctypes.CDLL(str(lib_path))
    assert lib.fastpng_variant() == 2
    arr = np.random.default_rng(1).integers(0, 256, (33, 47, 3), np.uint8)
    out = str(tmp_path / "abi.png")
    lib.fastpng_write_v2.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_char_p]
    assert lib.fastpng_write_v2(arr.ctypes.data_as(ctypes.c_char_p), 47, 33, 3, 3, out.encode()) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(out)), arr)
    canvas = np.ascontiguousarray(
        np.asarray(Image.open(os.path.join(GOLDENS, "fast_pitch_grid_200dpi.png")).convert("RGB")))
    abi, main = tmp_path / "abi_canvas.png", tmp_path / "main_canvas.png"
    h, w = canvas.shape[:2]
    assert lib.fastpng_write_v2(canvas.ctypes.data_as(ctypes.c_char_p), w, h, 3, 3, str(abi).encode()) == 0
    fastpng.write_png_rgb(canvas, str(main), 3)
    assert abi.read_bytes() == main.read_bytes()


def test_a_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastpng, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ could not build") as err:
        fastpng._compile(tmp_path / "libbroken.so")
    assert str(bad) in str(err.value)
    assert not list(tmp_path.glob("libbroken.so*"))  # no temporary left behind
