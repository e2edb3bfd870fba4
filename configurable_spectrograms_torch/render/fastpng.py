"""ctypes bindings for the native PNG encoder, run blit and text blend (port of ``render/fastpng.py``).

``native/fastpng.cpp`` (the port's own copy of the repository's
``native/fastpng.cpp``) writes RGB PNGs with a fixed Up filter and a
run/LZ fixed-Huffman deflate for mostly-white canvases (in every build;
the JAX package's copy has it only with libdeflate, so a host with only
zlib encoded several times slower), blits quantized index runs into the
figure canvas, and alpha-blends cached text tiles.  Each call releases
the interpreter lock for its whole run (ctypes does), so the batch
driver's worker threads encode in parallel.

One figure's run/LZ deflate is itself split into row stripes, cut at
16-row blocks, one per 128 KiB of filtered scanlines, at most 16.  The
canvas's shape alone sets the count, so its bytes are the same on every
host and under any load.  The stripes are parsed apart (each first parses
the 32 KB of rows above it, so it finds the matches one parse would) and
their bits joined into the one fixed-Huffman block of the one IDAT, with
their adler-32 and CRC-32 values combined: the file is within a few
hundred bytes of one stripe's.  A canvas under 256 KiB filtered is one
stripe, the serial encoder's bytes.

A process-wide pool of min(cores / 2 - 1, 15) native helper threads,
started at the first striped encode, encodes the stripes: half the cores,
with the caller, so the interpreter's threads (a batch's compositing
workers, the render dispatcher) keep the other half.  The calling thread
queues stripes 1..K-1, encodes stripe 0 and any stripe no helper has
started, and joins the finished ones in between; so under other workers'
encodes a call falls back toward the serial cost instead of queueing.  A forked child starts a pool
of its own.  Each thread keeps one grow-only buffer the size of a stripe
(~2.2 MB for a 4800 x 2400 canvas), not of a canvas.  With a stage timer
set (``utils.timing.ACTIVE``) each encode records one ``png_stripe`` stage
a stripe: the seconds its thread took, and its interval on
``time.perf_counter``'s clock (the encoder reads ``CLOCK_MONOTONIC``,
which is that clock on Linux) with no thread, as a helper is no Python
thread.

The library is compiled with ``g++`` at first use into
``ops._build.cache_dir()``, the kernel library's directory
(``CST_NATIVE_CACHE_DIR``, else ``build/cst_torch/`` in a source
checkout, else ``~/.cache/configurable_spectrograms_torch/``), named by
a digest of the source and of this host's CPU flags (the build uses
``-march=native``), once per process under a lock and atomically across
processes (a pid-unique temporary, then ``os.replace``).  Variants are
tried in order: libdeflate, then zlib, then zlib's stable ABI declared in
the source for a host without either header (linked against the
``libz.so.1`` Python's own ``zlib`` module loads).
:data:`BUILD_INFO` records which variant built and the compiler's log; a
build writes one ``[BUILD]`` line with its seconds to the run's log.

Unlike the JAX module, nothing falls back to PIL: a failed build raises
with the compiler's log, and a failed encode raises.  The one contract
choice is the text blend: :func:`blend_route` is ``"native"`` only when a
one-shot probe finds the kernel byte-equal to this Pillow's
``Image.paste``; otherwise text keeps ``Image.paste``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from configurable_spectrograms_torch.utils import timing

SRC = Path(__file__).resolve().parent.parent / "native" / "fastpng.cpp"

#: What the last load did: ``variant`` built (``libdeflate``, ``zlib`` or
#: ``zlib-abi``), ``path`` of the library, ``seconds`` compiling (0.0 when a
#: built library was loaded) and the compiler's ``log``.
BUILD_INFO: dict[str, object] = {"variant": None, "path": "", "seconds": 0.0, "log": ""}

_LIB: list[ctypes.CDLL] = []
_LOCK = threading.Lock()
_BLEND_OK: list[bool] = []  # the probe's verdict, once per process


def _host_tag() -> str:
    """A short digest of this host's CPU flags: a ``-march=native`` build is valid only on such a CPU."""
    basis = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    basis += ":" + line.split(":", 1)[1].strip()
                    break
    except OSError:
        basis += ":" + platform.processor()
    return hashlib.sha256(basis.encode()).hexdigest()[:10]


def library_path() -> Path:
    """Where the library for the current source and this host lives."""
    from configurable_spectrograms_torch.ops._build import cache_dir

    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return cache_dir() / f"libfastpng-{digest}-{_host_tag()}.so"


def _libz_path() -> str:
    """The ``libz.so.1`` that Python's ``zlib`` module loaded (for the ``zlib-abi`` variant)."""
    import zlib  # noqa: F401 - maps libz into this process

    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.split()[-1]
                if os.path.basename(path).startswith("libz.so"):
                    return path
    except OSError:
        pass
    import ctypes.util

    return ctypes.util.find_library("z") or "libz.so.1"


def _variants() -> list[tuple[str, list[str]]]:
    deflate = ["-DFASTPNG_USE_LIBDEFLATE", "-ldeflate"]
    abi = ["-DFASTPNG_ZLIB_ABI", _libz_path()]
    return [
        ("libdeflate", ["-march=native", *deflate]),
        ("libdeflate", ["-mssse3", *deflate]),
        ("libdeflate", deflate),
        ("zlib", ["-march=native", "-lz"]),
        ("zlib", ["-mssse3", "-lz"]),
        ("zlib", ["-lz"]),
        ("zlib-abi", ["-march=native", *abi]),
        ("zlib-abi", abi),
    ]


def _compile(lib: Path) -> str:
    """Compile the source to *lib*; returns the variant that built, or raises with every attempt's log."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    log = []
    for variant, extra in _variants():
        cmd = ["g++", "-O3", "-fPIC", "-shared", "-pthread", "-o", tmp, str(SRC), *extra]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
        except (OSError, subprocess.TimeoutExpired) as exc:
            log.append(f"$ {' '.join(cmd)}\n{exc}")
            continue
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode == 0:
            os.replace(tmp, lib)
            BUILD_INFO["log"] = "\n".join(log)
            return variant
        try:
            os.remove(tmp)
        except OSError:
            pass
    raise RuntimeError("g++ could not build the native PNG encoder:\n" + "\n".join(log))


def _declare(lib: ctypes.CDLL) -> None:
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    # px, w, h, channels, zlevel, path, stripes (0 = by shape), each stripe's (start, end) (or None)
    lib.fastpng_write_v3.argtypes = [ctypes.c_char_p, I32, I32, I32, I32, ctypes.c_char_p, I32,
                                     ctypes.POINTER(ctypes.c_double)]
    lib.fastpng_stripe_count.argtypes = [I32, I32]
    # idx, idx_row_stride, t_idx, x_ok, sel, starts, counts, n_runs, lut, out, out_row_stride, oh, ow
    lib.fastpng_blit_runs.argtypes = [P, I64, P, P, P, P, P, I32, P, P, I64, I32, I32]
    # canvas, canvas_stride, H, W, tile, tw, th, x0, y0
    lib.fastpng_blend_tile.argtypes = [P, I64, I32, I32, P, I32, I32, I32, I32]
    lib.fastpng_variant.argtypes = []
    for fn in (lib.fastpng_write_v3, lib.fastpng_stripe_count, lib.fastpng_blit_runs, lib.fastpng_blend_tile,
               lib.fastpng_variant):
        fn.restype = ctypes.c_int32


def library() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises with the compiler's log when it cannot be built."""
    with _LOCK:
        if not _LIB:
            lib_path = library_path()
            t0 = time.perf_counter()
            built = None
            if not lib_path.exists():
                built = _compile(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            _declare(lib)
            variant = {0: "zlib", 1: "libdeflate", 2: "zlib-abi"}[lib.fastpng_variant()]
            if built is not None and built != variant:
                raise RuntimeError(f"built the {built} variant but loaded {variant} from {lib_path}")
            BUILD_INFO.update(variant=variant, path=str(lib_path),
                              seconds=time.perf_counter() - t0 if built else 0.0)
            if built:
                from configurable_spectrograms_torch.utils.logging import log_message

                log_message(f"[BUILD] PNG encoder ({variant}) built in {BUILD_INFO['seconds']:.2f} s: {lib_path}",
                            force_flush=True)
            _LIB.append(lib)
        return _LIB[0]


def write_png_rgb(array: np.ndarray, path: str, compress_level: int = 3) -> None:
    """Write an (H, W, 3|4) uint8 array as an RGB PNG (RGBA has its alpha dropped in the encoder)."""
    a = np.ascontiguousarray(array, dtype=np.uint8)
    if a.ndim != 3 or a.shape[2] not in (3, 4) or a.shape[0] <= 0 or a.shape[1] <= 0:
        raise ValueError(f"write_png_rgb takes a non-empty (H, W, 3|4) array, got {a.shape}")
    h, w = a.shape[:2]
    lib = library()
    timer = timing.ACTIVE
    times = (ctypes.c_double * (2 * lib.fastpng_stripe_count(w, h)))() if timer is not None else None
    rc = lib.fastpng_write_v3(a.ctypes.data_as(ctypes.c_char_p), w, h, a.shape[2], compress_level,
                              os.fsencode(path), 0, times)
    if rc < 0:
        raise OSError(f"native PNG encoder failed ({rc}) writing {path}")
    if timer is not None:
        for k in range(rc):
            timer.add("png_stripe", times[2 * k + 1] - times[2 * k], t_end=times[2 * k + 1])


def blit_runs(idx: np.ndarray, t_idx: np.ndarray, x_ok: np.ndarray, sel: np.ndarray, starts: np.ndarray,
              counts: np.ndarray, lut_ext: np.ndarray, out: np.ndarray) -> bool:
    """Native gather + colour + run replication into *out* (an RGBA canvas rect).

    The one-pass C++ twin of the numpy tail of
    :func:`configurable_spectrograms_torch.render.tile.resample_indices`
    (integer and uint8 operations only, so the output is bit-identical).
    Returns False, writing nothing, for a layout the kernel does not take
    or an index out of range (where the numpy tail raises); the caller then
    runs the numpy tail.
    """
    oh, ow = int(out.shape[0]), int(out.shape[1])
    if oh <= 0 or ow <= 0:
        return True
    if (
        idx.dtype != np.uint8
        or idx.ndim != 2
        # A negative row stride would make the kernel's size_t row offsets
        # undefined; a zero stride (a broadcast view) is fine.
        or idx.strides[0] < 0
        or idx.strides[1] != 1
        or out.dtype != np.uint8
        or out.ndim != 3
        or out.shape[2] != 4
        or out.strides[0] < 0
        or out.strides[1] != 4
        or out.strides[2] != 1
    ):
        return False
    t_idx = np.ascontiguousarray(t_idx, np.int32)
    x_ok = np.ascontiguousarray(x_ok, np.uint8)
    sel = np.ascontiguousarray(sel, np.int32)
    starts = np.ascontiguousarray(starts, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    lut_ext = np.ascontiguousarray(lut_ext, np.uint8)
    if len(t_idx) < ow or len(x_ok) < ow or lut_ext.shape != (257, 4) or not (len(sel) == len(starts) == len(counts)):
        return False
    # The kernel has no bounds checks: two small scans keep a bad row or
    # column from becoming an out-of-bounds read.
    used_t = t_idx[:ow]
    if used_t.min() < 0 or used_t.max() >= idx.shape[0]:
        return False
    if sel.size and (sel.min() < 0 or sel.max() >= idx.shape[1]):
        return False
    rc = library().fastpng_blit_runs(
        idx.ctypes.data, idx.strides[0], t_idx.ctypes.data, x_ok.ctypes.data, sel.ctypes.data,
        starts.ctypes.data, counts.ctypes.data, len(sel), lut_ext.ctypes.data, out.ctypes.data,
        out.strides[0], oh, ow,
    )
    if rc != 0:
        raise RuntimeError(f"fastpng_blit_runs failed ({rc})")
    return True


def _blend_matches_pillow(blend) -> bool:
    """True when *blend* (the kernel's signature) is byte-equal to this Pillow's ``Image.paste``."""
    from PIL import Image

    rng = np.random.default_rng(0)
    h = w = 64
    canvas = rng.integers(0, 256, (h, w, 4), np.uint8)
    tile = rng.integers(0, 256, (h, w, 4), np.uint8)
    tile[..., 3] = np.arange(h * w, dtype=np.uint32).reshape(h, w) % 256
    pil = Image.fromarray(canvas.copy(), "RGBA")
    pil.paste(Image.fromarray(tile, "RGBA"), (0, 0), Image.fromarray(tile, "RGBA"))
    native = np.ascontiguousarray(canvas.copy())
    rc = blend(native.ctypes.data, native.strides[0], h, w, np.ascontiguousarray(tile).ctypes.data, w, h, 0, 0)
    return rc == 0 and np.array_equal(native, np.asarray(pil))


def blend_route() -> str:
    """``"native"`` when the blend kernel is byte-equal to this Pillow's paste (probed once), else ``"Image.paste"``.

    The kernel is Pillow >= 9.1's precise-division RGBA blend; an older
    Pillow pastes with the legacy rounding, which differs on ~24.5% of
    byte triples, and then text keeps ``Image.paste``.
    """
    lib = library()
    with _LOCK:
        if not _BLEND_OK:
            _BLEND_OK.append(_blend_matches_pillow(lib.fastpng_blend_tile))
        return "native" if _BLEND_OK[0] else "Image.paste"


def _canvas_ok(canvas: np.ndarray) -> bool:
    return (canvas.dtype == np.uint8 and canvas.ndim == 3 and canvas.shape[2] == 4 and canvas.strides[0] >= 0
            and canvas.strides[1] == 4 and canvas.strides[2] == 1)


def _tile_ok(tile: np.ndarray) -> bool:
    return tile.dtype == np.uint8 and tile.ndim == 3 and tile.shape[2] == 4 and tile.flags.c_contiguous


def canvas_blender(canvas: np.ndarray):
    """A per-canvas ``paste(tile, x, y) -> bool`` closure, or None where the native blend is not in use.

    A figure pastes ~120 cached text tiles into one canvas: the canvas is
    checked and its ctypes fields cached once, so each paste is one ctypes
    call.  ``paste`` returns False for a tile the kernel does not take.
    """
    if blend_route() != "native" or not _canvas_ok(canvas):
        return None
    blend = library().fastpng_blend_tile
    data, stride = canvas.ctypes.data, int(canvas.strides[0])
    H, W = int(canvas.shape[0]), int(canvas.shape[1])

    # ``_pinned`` keeps the canvas buffer alive as long as the closure.
    def paste(tile: np.ndarray, x: int, y: int, _pinned=canvas) -> bool:
        if not _tile_ok(tile):
            return False
        return blend(data, stride, H, W, tile.ctypes.data, tile.shape[1], tile.shape[0], x, y) == 0

    return paste


def blend_tile(canvas: np.ndarray, tile: np.ndarray, x: int, y: int) -> bool:
    """Alpha-blend an RGBA *tile* into *canvas* at (*x*, *y*) with the kernel.

    The arithmetic twin of ``Image.paste(tile, (x, y), tile)`` on RGBA (the
    precise-division blend on every channel, alpha included), clipped as
    PIL clips.  Returns False for a layout the kernel does not take.
    """
    if not (_canvas_ok(canvas) and _tile_ok(tile)):
        return False
    rc = library().fastpng_blend_tile(canvas.ctypes.data, canvas.strides[0], canvas.shape[0], canvas.shape[1],
                                      tile.ctypes.data, tile.shape[1], tile.shape[0], x, y)
    return rc == 0
