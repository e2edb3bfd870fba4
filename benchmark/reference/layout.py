"""Where a figure's data tiles lie in its PNG, worked out from the figure's size, grid and text.

The rule the port's compositor states for its pixel layout: a figure of
``figsize`` inches at ``dpi`` is cut into equal cells under the title and
above the footer, and each cell's tile is what is left inside margins
sized from the tick and label text.  The text is measured with PIL from
the font file the port draws with (a file both sides read).  A tile's
frame covers its outer pixels, and a cusp marker's line covers the columns
around it; :func:`covered_columns` names those.
"""

from __future__ import annotations

import functools

TICK_LABEL_PT = 15.0
AXIS_LABEL_PT = 18.0
FONT = "configurable_spectrograms_torch/render/fonts/DejaVuSans.ttf"  # relative to the checkout


def pt_to_px(points: float, dpi: float) -> int:
    return max(1, round(points * dpi / 72.0))


class Text:
    """Text extents in pixels, measured as the port's compositor measures them."""

    def __init__(self, font_path: str):
        self.font_path = font_path

    @functools.lru_cache(maxsize=64)
    def _font(self, px: int):
        from PIL import ImageFont

        return ImageFont.truetype(self.font_path, px)

    @functools.cached_property
    def _draw(self):
        from PIL import Image, ImageDraw

        return ImageDraw.Draw(Image.new("RGB", (8, 8)))

    def size(self, text: str, px: int) -> tuple[int, int]:
        if not text:
            return 0, 0
        w = h = 0
        for line in text.split("\n"):
            box = self._draw.textbbox((0, 0), line or " ", font=self._font(px))
            w = max(w, box[2] - box[0])
            h += box[3] - box[1] + max(2, px // 5)
        return w, h


def tile_rects(text: Text, figsize: tuple[float, float], dpi: float, nrows: int, ncols: int,
               suptitle: tuple[str, float] | None, bottom_reserve: float,
               row_label_lines: int) -> dict[tuple[int, int], tuple[int, int, int, int]]:
    """(row, col) -> the tile's half-open pixel rect (x0, y0, x1, y1).

    *suptitle* is (text, points) or None; *row_label_lines* is the line
    count of the first column's multi-line row labels (0 where they have
    one line).
    """
    W = max(8, round(figsize[0] * dpi))
    H = max(8, round(figsize[1] * dpi))
    tick_px, label_px, tick_len = pt_to_px(TICK_LABEL_PT, dpi), pt_to_px(AXIS_LABEL_PT, dpi), pt_to_px(8, dpi)
    sup_h = text.size(suptitle[0], pt_to_px(suptitle[1], dpi))[1] + tick_px if suptitle else 0
    grid_h = H - sup_h - round(H * max(bottom_reserve, 0.0))
    cell_w, cell_h = W // ncols, grid_h // nrows
    num_w = text.size("30000", tick_px)[0]
    m_left = label_px + num_w + tick_len + round(0.04 * cell_w)
    if row_label_lines > 1:
        m_left += row_label_lines * round(label_px * 1.25)
    m_right = round(0.16 * cell_w) + num_w + label_px
    m_top = round(label_px * 1.6)
    m_bottom = tick_len + round(tick_px * 1.4) + round(label_px * 1.5) + round(0.10 * cell_h)
    tile_w, tile_h = max(8, cell_w - m_left - m_right), max(8, cell_h - m_top - m_bottom)
    rects = {}
    for r in range(nrows):
        for c in range(ncols):
            x0, y0 = c * cell_w + m_left, sup_h + r * cell_h + m_top
            rects[(r, c)] = (x0, y0, x0 + tile_w, y0 + tile_h)
    return rects


def frame_px(dpi: float) -> int:
    """The width of a tile's black frame, drawn over the tile's outer pixels."""
    return max(1, round(dpi / 100))


def covered_columns(marker_px: list[float], dpi: float, width: int) -> set[int]:
    """Tile columns a cusp marker's line (4 pt, centred on the marker) may cover, with a pixel to spare."""
    half = max(1, pt_to_px(4, dpi)) / 2 + 2
    cols: set[int] = set()
    for px in marker_px:
        cols.update(c for c in range(int(px - half), int(px + half) + 2) if 0 <= c < width)
    return cols
