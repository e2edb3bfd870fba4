"""Font loading and text drawing helpers for the PIL compositor.

Uses DejaVu Sans (matplotlib's default font family, so rendered figures
look like the reference's).  The port carries the font file itself
(``fonts/DejaVuSans.ttf``, Bitstream Vera licence in ``fonts/LICENSE_DEJAVU``):
a host without matplotlib and without system fonts would otherwise fall
back to PIL's 10-px default font whatever size a label asks for.

A copy of the JAX package's ``render/text.py`` with two changes: PIL is
imported inside the functions that draw, and the font is the bundled one
(the JAX module searches matplotlib's data directory and a few system
paths, and falls back to PIL's default font).  Cached text tiles are
pasted by the native blend (:func:`..render.fastpng.canvas_blender`) where
it is byte-equal to this Pillow's ``Image.paste``, else by ``Image.paste``.
"""

from __future__ import annotations

import functools
import os

import numpy as np

#: The font the port carries (same file as matplotlib's DejaVuSans.ttf).
BUNDLED_FONT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fonts", "DejaVuSans.ttf")

#: Distinguishes "never resolved for this canvas" from a resolved None
#: (native blend not in use) in the per-canvas paste cache.
_UNSET = object()


def _font_path() -> str:
    """The font file every label is drawn with: the one the port carries."""
    return BUNDLED_FONT


@functools.lru_cache(maxsize=64)
def get_font(px: int):
    """A font whose nominal size is *px* pixels."""
    from PIL import ImageFont

    return ImageFont.truetype(_font_path(), px)


def pt_to_px(points: float, dpi: float) -> int:
    """Convert a point size to pixels at *dpi* (matplotlib's 72 pt/inch)."""
    return max(1, round(points * dpi / 72.0))


@functools.lru_cache(maxsize=1)
def _measure():
    """The shared measurement-only draw context."""
    from PIL import Image, ImageDraw

    return ImageDraw.Draw(Image.new("RGB", (8, 8)))


def _paste_tile(canvas, tile, x: int, y: int) -> None:
    """``canvas.paste(tile, (x, y), tile)``, through the native blend where it is in use.

    A figure pastes ~120 small cached text tiles, and PIL's per-paste
    dispatch dwarfs the blending.  When the canvas is the compositor's
    numpy-backed figure canvas (``_np_canvas``, shared memory with the PIL
    Image) and :func:`..render.fastpng.blend_route` is ``"native"``, each
    paste is one ctypes call with byte-identical output; otherwise (and for
    tiles the kernel does not take) it is ``Image.paste``.  The tile's RGBA
    bytes are cached on the Image object: tiles are lru-cached and
    immutable once built.
    """
    np_canvas = getattr(canvas, "_np_canvas", None)
    if np_canvas is not None:
        paste = getattr(canvas, "_blend_paste", _UNSET)
        if paste is _UNSET:
            from configurable_spectrograms_torch.render import fastpng

            paste = canvas._blend_paste = fastpng.canvas_blender(np_canvas)
        if paste is not None:
            arr = getattr(tile, "_np_rgba", None)
            if arr is None and tile.mode == "RGBA":
                arr = np.asarray(tile, dtype=np.uint8)
                if not (arr.ndim == 3 and arr.shape[2] == 4 and arr.flags.c_contiguous):
                    arr = False
                tile._np_rgba = arr
            if arr is not None and arr is not False and paste(arr, x, y):
                return
    canvas.paste(tile, (x, y), tile)


@functools.lru_cache(maxsize=16384)
def text_size(text: str, px: int) -> tuple[int, int]:
    """(width, height) in pixels of *text* at font size *px* (memoized --
    tick labels and titles repeat across panels and figures)."""
    if not text:
        return 0, 0
    lines = text.split("\n")
    font = get_font(px)
    w = h = 0
    for line in lines:
        box = _measure().textbbox((0, 0), line or " ", font=font)
        w = max(w, box[2] - box[0])
        h += box[3] - box[1] + max(2, px // 5)
    return w, h


@functools.lru_cache(maxsize=8192)
def _text_tile(text: str, px: int, fill):
    """Render one line of text to a cached RGBA tile.

    Figures repeat the same strings constantly (axis labels, tick times,
    "Counts"); caching the rendered bitmaps and pasting cuts per-figure
    text time by ~10x.  Returns (tile, bbox_x0, bbox_y0) so callers can
    reproduce draw.text's own positioning.
    """
    from PIL import Image, ImageDraw

    font = get_font(px)
    x0, y0, x1, y1 = _measure().textbbox((0, 0), text, font=font)
    tile = Image.new("RGBA", (max(1, x1 - x0), max(1, y1 - y0)), (0, 0, 0, 0))
    ImageDraw.Draw(tile).text((-x0, -y0), text, font=font, fill=fill)
    return tile, x0, y0


def draw_text(
    draw,
    xy: tuple[float, float],
    text: str,
    px: int,
    fill: str | tuple = "black",
    anchor: str = "la",
) -> None:
    """Draw (possibly multi-line) *text*; multi-line is centered per line.

    Single-line text goes through a cached-bitmap paste when the target
    image is reachable; multi-line and fallback cases use PIL directly.
    """
    if not text:
        return
    font = get_font(px)
    if "\n" in text:
        draw.multiline_text(xy, text, font=font, fill=fill, anchor=anchor.replace("s", "a"), align="center")
        return
    canvas = getattr(draw, "_image", None)
    if canvas is None:
        draw.text(xy, text, font=font, fill=fill, anchor=anchor)
        return
    tile, bx0, by0 = _text_tile(text, px, fill if isinstance(fill, str) else tuple(fill))
    w, h = tile.size
    x, y = xy
    ha, va = (anchor + "a")[0], (anchor + "a")[1]
    if ha == "m":
        x -= w / 2
    elif ha == "r":
        x -= w
    else:  # 'l': draw.text would offset by the bbox's left bearing
        x += bx0
    if va == "m":
        y -= h / 2
    elif va in ("s", "d", "b"):
        y -= h
    else:  # 'a' (ascender): mimic draw.text's top offset
        y += by0
    _paste_tile(canvas, tile, round(x), round(y))


@functools.lru_cache(maxsize=2048)
def _rotated_tile(text: str, px: int, angle: float, fill):
    """Pre-rendered rotated text bitmap (row labels and colorbar labels
    repeat across panels/figures, so this is nearly always a cache hit).

    rotate(expand=True) pads the corners with transparency; cropping the
    content bbox keeps the paste cost proportional to the glyphs.  Returns
    ``(tile, w0, h0, lx, ly)``: the caller must anchor on the ORIGINAL
    (w0, h0) extent and then offset by the crop origin (lx, ly) -- Python's
    round-half-even is not translation-invariant, so rounding the cropped
    geometry directly can drift placement by a pixel.
    """
    from PIL import Image, ImageDraw

    w, h = text_size(text, px)
    if w == 0:
        return None
    tmp = Image.new("RGBA", (w + 4, h + 4), (0, 0, 0, 0))
    d = ImageDraw.Draw(tmp)
    font = get_font(px)
    if "\n" in text:
        d.multiline_text((2, 2), text, font=font, fill=fill, align="center")
    else:
        d.text((2, 2), text, font=font, fill=fill)
    rot = tmp.rotate(angle, expand=True)
    w0, h0 = rot.width, rot.height
    box = rot.getbbox()
    lx = ly = 0
    if box is not None and box != (0, 0, w0, h0):
        lx, ly = box[0], box[1]
        rot = rot.crop(box)
    return rot, w0, h0, lx, ly


def draw_rotated_text(
    canvas,
    center: tuple[float, float],
    text: str,
    px: int,
    angle: float = 90.0,
    fill: str | tuple = "black",
) -> None:
    """Draw *text* rotated by *angle* degrees, centered at *center*."""
    if not text:
        return
    entry = _rotated_tile(text, px, float(angle), fill if isinstance(fill, str) else tuple(fill))
    if entry is None:
        return
    rot, w0, h0, lx, ly = entry
    _paste_tile(canvas, rot, round(center[0] - w0 / 2) + lx, round(center[1] - h0 / 2) + ly)


@functools.lru_cache(maxsize=4096)
def _pow10_metrics(exponent: int, px: int) -> tuple[int, int]:
    """(base_width, superscript_width) for ``10^exponent`` at size *px*.

    Pure measurement (no pixels involved), so caching is exact; the same
    handful of exponents label every colorbar and log axis in a batch.
    """
    f_base = get_font(px)
    f_sup = get_font(max(1, round(px * 0.72)))
    bw = _measure().textbbox((0, 0), "10", font=f_base)[2]
    sw = _measure().textbbox((0, 0), str(exponent), font=f_sup)[2]
    return bw, sw


@functools.lru_cache(maxsize=4096)
def _pow10_tile(exponent: int, px: int, fill):
    """``10^exponent`` pre-rendered to one RGBA tile.

    Both glyph runs are drawn together at integer positions, so their
    relative baseline/superscript alignment is rendered by PIL exactly as
    the direct path would; the caller pastes the whole pair.  A batch
    reuses the same handful of exponents on every colorbar and log axis,
    so this is nearly always a cache hit (glyph rasterization was ~half
    the compositor's text time).  Returns ``(tile, y_ref)`` where
    ``y_ref`` is the tile row matching the caller's anchor midline.
    """
    from PIL import Image, ImageDraw

    bw, sw = _pow10_metrics(exponent, px)
    w = bw + sw + 2
    h = max(4, px * 3)
    y_ref = h // 2
    tile = Image.new("RGBA", (w, h), (0, 0, 0, 0))
    d = ImageDraw.Draw(tile)
    d.text((0, y_ref), "10", font=get_font(px), fill=fill, anchor="lm")
    d.text(
        (bw + 1, y_ref - px * 0.35),
        str(exponent),
        font=get_font(max(1, round(px * 0.72))),
        fill=fill,
        anchor="lm",
    )
    # The working tile is 3*px tall so the superscript can land anywhere;
    # the glyphs occupy ~1/3 of that.  Crop the empty rows (vertical only:
    # the caller's x placement is relative to the tile's left edge, and
    # horizontal bearing must stay rendered-in).  Pasting the trimmed tile
    # blends only real rows -- alpha-0 pixels are exact blend no-ops, so
    # output is bit-identical at ~1/3 the paste cost.
    box = tile.getbbox()
    if box is not None and (box[1] > 0 or box[3] < h):
        tile = tile.crop((0, box[1], w, box[3]))
        y_ref -= box[1]
    return tile, y_ref


def draw_pow10(
    draw,
    xy: tuple[float, float],
    exponent: int,
    px: int,
    fill: str | tuple = "black",
    anchor_left: bool = True,
) -> int:
    """Draw ``10^exponent`` with a raised superscript; returns total width.

    Replaces the reference's mathtext ``$10^{k}$`` colorbar/axis labels
    (reference plotting.py:292-298).
    """
    bw, sw = _pow10_metrics(exponent, px)
    x, y = xy
    if not anchor_left:
        x -= bw + sw
    # ``ImageDraw._image`` is Pillow >= 9.2 (same access draw_text relies
    # on).  Without it the direct-draw fallback below renders at subpixel
    # positions, which can differ from the tile path's integer placement
    # by <=1 px -- regenerate the goldens if the environment's Pillow
    # ever loses this attribute.
    canvas = getattr(draw, "_image", None)
    if canvas is not None:
        tile, y_ref = _pow10_tile(exponent, px, fill if isinstance(fill, str) else tuple(fill))
        _paste_tile(canvas, tile, round(x), round(y) - y_ref)
    else:  # measurement-only draws (no backing image): direct render
        draw.text((x, y), "10", font=get_font(px), fill=fill, anchor="lm")
        draw.text(
            (x + bw + 1, y - px * 0.35),
            str(exponent),
            font=get_font(max(1, round(px * 0.72))),
            fill=fill,
            anchor="lm",
        )
    return bw + sw + 1


def pow10_width(exponent: int, px: int) -> int:
    bw, sw = _pow10_metrics(exponent, px)
    return bw + sw + 1
