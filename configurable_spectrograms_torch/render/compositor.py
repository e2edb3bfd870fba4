"""Pixel layout and PIL compositing for rendered figures.

Owns the figure-canvas recycling pool and :class:`_Layout`, which turns a
``SpectroFigure``'s panel grid plus the device/host rasterization results
into the final RGBA image: numpy-blitted data tiles and colorbar strips,
then PIL-drawn frames, ticks, labels, cusp markers, and titles in the
same shared buffer.  Replaces the reference's matplotlib Agg draw
(reference plotting.py:229-235,336-387,505-698) with direct drawing
around device-produced tiles.

A copy of the JAX package's ``render/compositor.py``: only the colormap
import changes, and PIL is imported inside :meth:`_Layout.composite`.
"""

from __future__ import annotations

import math
import os
import threading
import weakref

import numpy as np

from configurable_spectrograms_torch.render import locators
from configurable_spectrograms_torch.render.cusp import CUSP_MARKER_DRAWERS
from configurable_spectrograms_torch.render.text import (
    draw_pow10,
    draw_rotated_text,
    draw_text,
    pow10_width,
    pt_to_px,
    text_size,
)

TICK_LABEL_PT = 15.0
AXIS_LABEL_PT = 18.0

#: Recycled figure canvases, keyed by (H, W).  Returned via a weakref
#: finalizer when the figure Image is collected, so a live Image's buffer
#: is never handed out twice.  Bounded to a handful of entries (a batch
#: renders a few distinct figure sizes).
_CANVAS_POOL: dict[tuple[int, int], list[np.ndarray]] = {}
_CANVAS_POOL_LOCK = threading.Lock()
# Per-size depth must cover the batch pools' concurrent figures: at 2,
# half of a 4-thread batch's renders paid the ~26 ms fresh-canvas fault
# per figure.  The depth follows the largest worker count any batch pool
# announces (ensure_canvas_pool_depth, called from recommended_workers)
# so bigger pools never silently under-recycle; CST_CANVAS_POOL_PER_SIZE
# pins it explicitly for memory-constrained hosts (~46 MB per canvas at
# 200 DPI, up to _CANVAS_POOL_MAX_SIZES sizes).
def _env_pool_depth() -> int | None:
    raw = os.environ.get("CST_CANVAS_POOL_PER_SIZE")
    if raw is None:
        return None
    try:
        return max(1, int(raw))
    except ValueError:
        return None


_CANVAS_POOL_MAX_PER_SIZE = _env_pool_depth() or 4
_CANVAS_POOL_MAX_SIZES = 4


def ensure_canvas_pool_depth(workers: int) -> None:
    """Grow the per-size canvas depth to cover *workers* concurrent figures.

    Called by the batch pool sizing path; an explicit
    ``CST_CANVAS_POOL_PER_SIZE`` wins over demand.
    """
    global _CANVAS_POOL_MAX_PER_SIZE
    if _env_pool_depth() is None:
        with _CANVAS_POOL_LOCK:
            _CANVAS_POOL_MAX_PER_SIZE = max(_CANVAS_POOL_MAX_PER_SIZE, int(workers))


def _acquire_canvas(h: int, w: int) -> np.ndarray:
    """A possibly-dirty (h, w, 4) canvas: the caller must whiten every pixel
    its blits won't overwrite (see :func:`_fill_outside`)."""
    import sys

    while True:
        with _CANVAS_POOL_LOCK:
            stack = _CANVAS_POOL.get((h, w))
            canvas = stack.pop() if stack else None
        if canvas is None:
            return np.empty((h, w, 4), np.uint8)
        # The canvas was pooled when its figure Image was garbage-collected,
        # so by now the Image's references (``_np_canvas`` attribute, the
        # frombuffer-shared core buffer) are gone.  Anything beyond the two
        # expected references (our local + getrefcount's argument) means an
        # embedder extracted the buffer and still holds it -- recycling it
        # would silently reset and redraw their pixels.  Drop such canvases
        # instead of reusing them.
        if sys.getrefcount(canvas) <= 2:
            return canvas


def _fill_outside(canvas: np.ndarray, rects: list[tuple[int, int, int, int]]) -> None:
    """Whiten every pixel of *canvas* NOT covered by *rects* (half-open).

    The pass-1 blits overwrite their rects completely -- every run row
    writes every column, out-of-extent columns included -- so a recycled
    canvas only needs its complement re-whitened.  On a 200-DPI pitch grid
    that skips the ~40% of background writes under the data tiles AND the
    second touch of those pages (fill then blit), which is where the
    memory-bandwidth-bound composite stage actually pays.
    """
    H, W = canvas.shape[0], canvas.shape[1]
    clipped = []
    for x0, y0, x1, y1 in rects:
        x0, y0 = max(int(x0), 0), max(int(y0), 0)
        x1, y1 = min(int(x1), W), min(int(y1), H)
        if x1 > x0 and y1 > y0:
            clipped.append((x0, y0, x1, y1))
    if not clipped:
        canvas[...] = 255
        return
    # Horizontal bands split at every rect edge: within a band each rect
    # either spans the band's full height or misses it entirely, so the
    # complement is the gaps between that band's sorted x spans.
    edges = sorted({0, H, *(r[1] for r in clipped), *(r[3] for r in clipped)})
    for y0, y1 in zip(edges, edges[1:]):
        spans = sorted((r[0], r[2]) for r in clipped if r[1] <= y0 and r[3] >= y1)
        x = 0
        for sx0, sx1 in spans:
            if sx0 > x:
                canvas[y0:y1, x:sx0] = 255
            if sx1 > x:
                x = sx1
        if x < W:
            canvas[y0:y1, x:W] = 255


def _release_canvas(canvas: np.ndarray) -> None:
    key = (canvas.shape[0], canvas.shape[1])
    with _CANVAS_POOL_LOCK:
        stack = _CANVAS_POOL.get(key)
        if stack is None:
            # Evict the least-recently-added size rather than refusing new
            # sizes: a batch mixing grid kinds cycles through sizes, and a
            # pool that stops recycling reinstates the per-figure 46 MB
            # fresh-canvas page-fault cost it exists to avoid.
            while len(_CANVAS_POOL) >= _CANVAS_POOL_MAX_SIZES:
                del _CANVAS_POOL[next(iter(_CANVAS_POOL))]
            stack = _CANVAS_POOL[key] = []
        if len(stack) < _CANVAS_POOL_MAX_PER_SIZE:
            stack.append(canvas)


class _Layout:
    """Pixel geometry and PIL compositing for one figure render."""

    def __init__(self, fig, dpi: float):
        self.fig = fig
        self.dpi = dpi
        self.W = max(8, round(fig.figsize[0] * dpi))
        self.H = max(8, round(fig.figsize[1] * dpi))
        self.tick_px = pt_to_px(TICK_LABEL_PT, dpi)
        self.label_px = pt_to_px(AXIS_LABEL_PT, dpi)
        self.tick_len = pt_to_px(8, dpi)

        self.sup_h = 0
        if fig.suptitle_text:
            self.sup_h = text_size(fig.suptitle_text, pt_to_px(fig.suptitle_pt, dpi))[1] + self.tick_px
        self.footer_h = round(self.H * max(fig.bottom_reserve, 0.0))

        grid_h = self.H - self.sup_h - self.footer_h
        self.cell_w = self.W // max(1, fig.ncols)
        self.cell_h = grid_h // max(1, fig.nrows)

        # Margins inside each cell (estimated text extents; the data tile
        # fills what remains).
        ytick_est = text_size("30000", self.tick_px)[0]
        self.m_left = self.label_px + ytick_est + self.tick_len + round(0.04 * self.cell_w)
        # Row labels (rotated multi-line) claim extra left space when present.
        extra = 0
        for ax in fig.axes:
            if ax.col == 0 and ax.ylabel and "\n" in ax.ylabel:
                lines = ax.ylabel.count("\n") + 1
                extra = max(extra, lines * round(self.label_px * 1.25))
        self.m_left += extra
        self.m_right = round(0.16 * self.cell_w) + text_size("30000", self.tick_px)[0] + self.label_px
        self.m_top = round(self.label_px * 1.6)
        self.m_bottom = self.tick_len + round(self.tick_px * 1.4) + round(self.label_px * 1.5) + round(
            0.10 * self.cell_h
        )

        self.tile_w = max(8, self.cell_w - self.m_left - self.m_right)
        self.tile_h = max(8, self.cell_h - self.m_top - self.m_bottom)

    def axes_rect(self, ax) -> tuple[int, int, int, int]:
        x0 = ax.col * self.cell_w + self.m_left
        y0 = self.sup_h + ax.row * self.cell_h + self.m_top
        return (x0, y0, x0 + self.tile_w, y0 + self.tile_h)

    # -- full composite -------------------------------------------------------

    def composite(self):
        # Pass 1: blit data tiles and colorbar strips straight into a numpy
        # canvas (pure memcpy, no PIL Image wrapping per tile).  Pass 2:
        # decorations (frames, ticks, text, markers) via PIL drawing into the
        # SAME memory: ``frombuffer`` shares the RGBA buffer with numpy, so
        # neither compositing nor the later PNG encode copies the canvas
        # (save_image reads ``_np_canvas``; the native encoder drops alpha).
        # Per-panel analysis errors (e.g. inverted log bounds) surface HERE,
        # at figure granularity: raising inside the pooled dispatch would
        # fail every concurrently-coalesced figure, permanently recording
        # innocent orbits as plotting errors (the reference errors only the
        # offending orbit).
        from PIL import Image, ImageDraw

        for ax in self.fig.axes:
            if ax.result is not None and ax.result.get("error"):
                raise ValueError(ax.result["error"])
        canvas = _acquire_canvas(self.H, self.W)
        _fill_outside(canvas, [r for ax in self.fig.axes for r in self._tile_rects(ax)])
        for ax in self.fig.axes:
            self._blit_tiles(canvas, ax)
        img = Image.frombuffer("RGBA", (self.W, self.H), canvas, "raw", "RGBA", 0, 1)
        img.readonly = 0  # the numpy buffer is writable; draw in place
        img._np_canvas = canvas
        # Recycle the canvas once the Image is garbage-collected: a batch
        # run re-faults ~46 MB of fresh canvas per figure otherwise, and on
        # this host the kernel's fresh-page path is intermittently 10-40x
        # slower than writes to already-mapped memory.
        weakref.finalize(img, _release_canvas, canvas)
        draw = ImageDraw.Draw(img)
        for ax in self.fig.axes:
            self._draw_axes(img, draw, ax)
        if self.fig.suptitle_text:
            draw_text(
                draw,
                (self.W / 2, max(2, self.sup_h // 4)),
                self.fig.suptitle_text,
                pt_to_px(self.fig.suptitle_pt, self.dpi),
                anchor="ma",
            )
        for t in self.fig.fig_texts:
            px = pt_to_px(t["pt"], self.dpi)
            x = t["x"] * self.W
            y = (1.0 - t["y"]) * self.H
            anchor = {"center": "m", "left": "l", "right": "r"}.get(t["ha"], "m") + {
                "bottom": "s",
                "top": "a",
                "center": "m",
            }.get(t["va"], "s")
            draw_text(draw, (x, y), t["s"], px, fill=t["color"], anchor=anchor)
        return img

    def _tile_rects(self, ax) -> list[tuple[int, int, int, int]]:
        """The canvas rects (half-open) :meth:`_blit_tiles` fully overwrites
        for this axes: the data tile and its colorbar gradient strip, or
        nothing when the axes draws no tile.  :meth:`composite` whitens only
        the complement of these rects, so they must match the blits exactly
        -- both methods read their geometry from here."""
        p, r = ax.panel, ax.result
        if p is None or r is None or bool(r["empty"]):
            return []
        x0, y0, x1, y1 = self.axes_rect(ax)
        cb_x0, _, cb_x1, _ = self._colorbar_rect((x0, y0, x1, y1))
        return [(x0, y0, x1, y1), (cb_x0, y0, cb_x1, y0 + self.tile_h)]

    def _colorbar_rect(self, rect: tuple[int, int, int, int]) -> tuple[int, int, int, int]:
        """The colorbar gradient strip for an axes *rect* (half-open).

        The single source of the strip's geometry: :meth:`_tile_rects`
        (which decides what the recycled canvas is NOT whitened over) and
        :meth:`_draw_colorbar` (which frames and ticks the strip) must
        agree exactly, or un-whitened canvas garbage shows through."""
        x0, y0, x1, y1 = rect
        cb_x0 = x1 + round(0.035 * self.cell_w)
        cb_w = max(4, round(0.045 * self.cell_w))
        return (cb_x0, y0, cb_x0 + cb_w, y1)

    def _blit_tiles(self, canvas: np.ndarray, ax) -> None:
        """Numpy-blit this axes' data tile and colorbar strip into *canvas*."""
        rects = self._tile_rects(ax)
        if not rects:
            return
        p, r = ax.panel, ax.result
        (x0, y0, x1, y1), (cb_x0, _, cb_x1, cb_y1) = rects
        if hasattr(r, "draw_rgba_into"):
            # Lazy panel results resample straight into the canvas rect --
            # no intermediate (tile_h, tile_w, 4) tile is ever allocated.
            r.draw_rgba_into(canvas[y0:y1, x0:x1])
        else:
            canvas[y0:y1, x0:x1] = r["rgba"][: y1 - y0, : x1 - x0]
        from configurable_spectrograms_torch.ops._colormap_data import colormap_lut

        h = cb_y1 - y0
        rows = np.clip(((1.0 - (np.arange(h) + 0.5) / h) * 256).astype(int), 0, 255)
        canvas[y0:cb_y1, cb_x0:cb_x1] = colormap_lut(p.colormap)[rows][:, None]

    def _draw_axes(self, img, draw, ax) -> None:
        rect = self.axes_rect(ax)
        x0, y0, x1, y1 = rect
        p, r = ax.panel, ax.result
        drew_tile = p is not None and r is not None and not bool(r["empty"])
        draw.rectangle([x0, y0, x1, y1], outline="black", width=max(1, round(self.dpi / 100)))

        if p is None or r is None or not drew_tile:
            # No data drawn (or device-side empty): frame + title only --
            # the y extent / color bounds in ``r`` are meaningless here.
            if ax.title:
                draw_text(draw, ((x0 + x1) / 2, y0 - 3), ax.title,
                          pt_to_px(ax.title_fontsize_pt, self.dpi), anchor="md")
            return

        self._draw_x_ticks(draw, rect, p)
        self._draw_y_ticks(draw, rect, p, r)
        self._draw_colorbar(img, draw, rect, p, r)

        if drew_tile and p.vertical_lines:
            xl0, xl1 = p.window.xlim
            span = (xl1 - xl0) or 1.0
            marker_px = [(v - xl0) / span * self.tile_w for v in p.vertical_lines]
            drawer = CUSP_MARKER_DRAWERS.get(p.cusp_marker_style, CUSP_MARKER_DRAWERS["both"])
            kw = dict(p.cusp_marker_kwargs)
            kw.setdefault("line_color", p.line_color)
            drawer(draw, rect, marker_px, self.dpi, **kw)

        if ax.title:
            draw_text(draw, ((x0 + x1) / 2, y0 - 3), ax.title,
                      pt_to_px(ax.title_fontsize_pt, self.dpi), anchor="md")
        if ax.xlabel:
            draw_text(draw, ((x0 + x1) / 2, y1 + self.tick_len + round(self.tick_px * 1.3)),
                      ax.xlabel, self.label_px, anchor="ma")
        if ax.ylabel:
            ytick_w = text_size("30000", self.tick_px)[0]
            cx = x0 - self.tick_len - ytick_w - self.label_px // 2 - 4
            if "\n" in ax.ylabel:
                cx -= (ax.ylabel.count("\n")) * round(self.label_px * 0.7)
            draw_rotated_text(img, (max(self.label_px // 2, cx), (y0 + y1) / 2), ax.ylabel,
                              self.label_px, angle=ax.ylabel_rotation)

    # -- tick drawing ---------------------------------------------------------

    def _draw_x_ticks(self, draw, rect, p) -> None:
        x0, y0, x1, y1 = rect
        xl0, xl1 = p.window.xlim
        span = (xl1 - xl0) or 1.0
        if p.x_is_unix:
            ticks, fmt = locators.time_ticks(xl0, xl1)
            labels = [locators.format_time_tick(t, fmt) for t in ticks]
        else:
            ticks = locators.nice_linear_ticks(xl0, xl1)
            labels = [locators.format_linear_tick(t) for t in ticks]
        for t, lab in zip(ticks, labels):
            px = x0 + (t - xl0) / span * self.tile_w
            if px < x0 - 0.5 or px > x1 + 0.5:
                continue
            draw.line([(px, y1), (px, y1 + self.tick_len)], fill="black", width=1)
            draw_text(draw, (px, y1 + self.tick_len + 2), lab, self.tick_px, anchor="ma")

    def _y_to_px(self, value: float, rect, p, r: dict) -> float | None:
        y0v, y1v = float(r["y0"]), float(r["y1"])
        if p.y_scale == "log":
            if value <= 0 or y0v <= 0 or y1v <= 0 or y1v == y0v:
                return None
            frac = (math.log10(value) - math.log10(y0v)) / (math.log10(y1v) - math.log10(y0v))
        else:
            if y1v == y0v:
                return None
            frac = (value - y0v) / (y1v - y0v)
        if frac < -1e-9 or frac > 1 + 1e-9:
            return None
        return rect[3] - frac * self.tile_h

    def _draw_y_ticks(self, draw, rect, p, r: dict) -> None:
        x0 = rect[0]
        if p.y_scale == "log":
            exps = locators.log_ticks(max(float(r["y0"]), 1e-300), float(r["y1"]))
            for k in exps:
                py = self._y_to_px(10.0**k, rect, p, r)
                if py is None:
                    continue
                draw.line([(x0 - self.tick_len, py), (x0, py)], fill="black", width=1)
                draw_pow10(draw, (x0 - self.tick_len - pow10_width(k, self.tick_px) - 2, py), k,
                           self.tick_px, anchor_left=True)
        else:
            ticks = locators.synthesize_linear_y_ticks(p.y_min, p.y_max)
            if not ticks:
                ticks = locators.nice_linear_ticks(float(r["y0"]), float(r["y1"]))
            for t in ticks:
                py = self._y_to_px(float(t), rect, p, r)
                if py is None:
                    continue
                draw.line([(x0 - self.tick_len, py), (x0, py)], fill="black", width=1)
                draw_text(draw, (x0 - self.tick_len - 3, py), locators.format_linear_tick(t),
                          self.tick_px, anchor="rm")

    def _draw_colorbar(self, img, draw, rect, p, r: dict) -> None:
        # The gradient strip was numpy-blitted in pass 1; draw its frame,
        # ticks, and label here.
        x0, y0, x1, y1 = rect
        cb_x0, _, cb_x1, _ = self._colorbar_rect(rect)
        cb_w = cb_x1 - cb_x0
        h = self.tile_h
        draw.rectangle([cb_x0, y0, cb_x0 + cb_w, y1], outline="black", width=1)

        vmin, vmax = float(r["vmin"]), float(r["vmax"])
        tick_max_w = 0
        if p.z_scale == "log" and vmin > 0 and vmax > vmin:
            lmin, lmax = math.log10(vmin), math.log10(vmax)
            exps = locators.log_ticks(vmin, vmax)
            # Label every decade tick unless they'd collide (wide dynamic
            # ranges, e.g. audio power spanning 12 decades).
            label_step = max(1, math.ceil(len(exps) * (self.tick_px * 1.4) / max(h, 1)))
            for j, k in enumerate(exps):
                frac = (k - lmin) / (lmax - lmin)
                py = y1 - frac * h
                draw.line([(cb_x0 + cb_w, py), (cb_x0 + cb_w + self.tick_len // 2, py)], fill="black", width=1)
                if j % label_step == 0:
                    w = draw_pow10(draw, (cb_x0 + cb_w + self.tick_len // 2 + 2, py), k, self.tick_px)
                    tick_max_w = max(tick_max_w, w)
        elif math.isfinite(vmin) and math.isfinite(vmax) and vmax > vmin:
            for t in locators.nice_linear_ticks(vmin, vmax):
                frac = (t - vmin) / (vmax - vmin)
                py = y1 - frac * h
                draw.line([(cb_x0 + cb_w, py), (cb_x0 + cb_w + self.tick_len // 2, py)], fill="black", width=1)
                lab = locators.format_linear_tick(t)
                draw_text(draw, (cb_x0 + cb_w + self.tick_len // 2 + 2, py), lab, self.tick_px, anchor="lm")
                tick_max_w = max(tick_max_w, text_size(lab, self.tick_px)[0])
        # Deliberate divergence: the reference stomps every colorbar label
        # to "Counts" at the end (reference plotting.py:387); we honor the
        # requested z_label so non-FAST data (e.g. the audio front-end's
        # "Power") stays truthful.  FAST/generic rows pass "Counts" anyway.
        label_x = cb_x0 + cb_w + self.tick_len // 2 + tick_max_w + self.label_px // 2 + 6
        draw_rotated_text(img, (min(label_x, self.W - self.label_px // 2 - 2), (y0 + y1) / 2),
                          p.z_label or "Counts", self.label_px, angle=90)
