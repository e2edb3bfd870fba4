"""Hold a written PNG's data tiles to the reference's colour indices, pixel by pixel.

Each pixel inside a tile's frame is read back to a colormap index (white
is the background outside the data) and compared with the index the
reference puts there.  The frame's pixels and the columns a cusp marker's
line covers are left out; every other pixel counts.  A pixel whose colour
is in no entry of the colormap counts as far off.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from reference import layout, panel
from reference.colormaps import lut

FAR = 999  # the gap of a pixel whose colour is no colormap entry


@dataclass
class Figure:
    """A figure's expected tiles: rows of panel specs, with what fixes the layout."""

    title: str | None
    rows: list[list[dict]]
    y_scale: str
    colormap: str
    figsize: tuple[float, float]
    dpi: float
    bottom_reserve: float
    label_lines: int
    title_pt: float = layout.AXIS_LABEL_PT + 2
    cache: dict = field(default_factory=dict, repr=False)

    def quantized(self, r: int, c: int) -> dict:
        """The panel's colour indices, worked out once."""
        if (r, c) not in self.cache:
            s = self.rows[r][c]
            self.cache[(r, c)] = panel.quantize(s["matrix"], s["energy"], s["y_range"], s["window"],
                                                s["z_bounds"], s["z_scale"], s["bounds_range"])
        return self.cache[(r, c)]


def decode(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _keys(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.int32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def _lookup(colormap: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sorted colour keys, least index, greatest index) of a colormap's entries and the white background."""
    table = lut(colormap)[:, :3]
    keys = np.concatenate([_keys(table), [0xFFFFFF]])
    idx = np.concatenate([np.arange(256), [panel.BACKGROUND]])
    uniq = np.unique(keys)
    lo = np.array([idx[keys == k].min() for k in uniq])
    hi = np.array([idx[keys == k].max() for k in uniq])
    return uniq, lo, hi


def gaps(observed_rgb: np.ndarray, expected: np.ndarray, colormap: str) -> np.ndarray:
    """Per pixel, how many colormap entries the observed colour lies from the expected index."""
    uniq, lo, hi = _lookup(colormap)
    k = _keys(observed_rgb)
    pos = np.clip(np.searchsorted(uniq, k), 0, len(uniq) - 1)
    found = uniq[pos] == k
    lo_i, hi_i = lo[pos], hi[pos]
    gap = np.where(expected < lo_i, lo_i - expected, np.where(expected > hi_i, expected - hi_i, 0))
    return np.where(found, gap, FAR)


def judge(img: np.ndarray, fig: Figure, text: layout.Text) -> dict:
    """{"compared", "off", "max_gap", "tiles_missing"} of one figure against one decoded PNG."""
    nrows, ncols = len(fig.rows), len(fig.rows[0])
    title = (fig.title, fig.title_pt) if fig.title else None
    rects = layout.tile_rects(text, fig.figsize, fig.dpi, nrows, ncols, title, fig.bottom_reserve,
                              fig.label_lines)
    fw = layout.frame_px(fig.dpi)
    out = {"compared": 0, "off": 0, "max_gap": 0, "tiles_missing": 0}
    want = (round(fig.figsize[1] * fig.dpi), round(fig.figsize[0] * fig.dpi))
    if img.shape[:2] != want:
        out["tiles_missing"] = nrows * ncols
        return out
    for (r, c), (x0, y0, x1, y1) in rects.items():
        spec = fig.rows[r][c]
        h, w = y1 - y0, x1 - x0
        expected = panel.tile(fig.quantized(r, c), h, w, fig.y_scale)
        xl0, xl1 = spec["window"].xlim
        span = (xl1 - xl0) or 1.0
        skip = layout.covered_columns([(v - xl0) / span * w for v in spec["marks"]], fig.dpi, w)
        cols = np.array([j for j in range(fw, w - fw) if j not in skip])
        g = gaps(img[y0 + fw : y1 - fw, x0:x1][:, cols], expected[fw : h - fw][:, cols], fig.colormap)
        out["compared"] += g.size
        out["off"] += int(np.count_nonzero(g))
        out["max_gap"] = max(out["max_gap"], int(g.max()) if g.size else 0)
    return out


def best(img: np.ndarray, figures: list[Figure], text: layout.Text) -> dict:
    """The judgement of whichever of *figures* the PNG matches best (fewest pixels off; the first on a tie),
    with that figure's position in the list under ``index``."""
    results = [dict(judge(img, f, text), index=i) for i, f in enumerate(figures)]
    return min(results, key=lambda r: (r["tiles_missing"], r["off"], r["max_gap"], r["index"]))
