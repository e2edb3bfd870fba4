"""Figure/axes model with deferred, batched rasterization (port of ``render/figure.py``).

A :class:`SpectroFigure` mirrors the slice of the matplotlib
``Figure``/``Axes`` API the reference's pipelines touch, but nothing
rasterizes until :meth:`SpectroFigure.savefig`/:meth:`render`: the figure
only accumulates :class:`PanelData` descriptions.  :func:`render_figures`
pools the panels of many figures into the bucketed dispatch, through the
render coalescer (:func:`..render.service.coalesced_render`), and the PIL
compositor draws frames, ticks, labels, colorbars, cusp markers and titles
around the tiles.  :func:`save_image` encodes with the native PNG encoder
(:mod:`.fastpng`) and queues the file for paced writeback
(:mod:`..utils.writeback`).  One host-compute gate slot
(:mod:`..utils.compute_gate`) spans a figure's render and encode.  PIL is
imported only by the composite and the non-PNG writes.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any

from configurable_spectrograms_torch.render.compositor import AXIS_LABEL_PT, _Layout
from configurable_spectrograms_torch.render.panel import PanelData

#: The dispatch's names this module re-exports, as the JAX package's does.
#: They resolve on first use: the dispatch imports torch, and a figure is
#: built before anything renders.
_DISPATCH_EXPORTS = ("PendingRender", "device_render_panels", "enqueue_render_panels")


def __getattr__(name: str):
    if name not in _DISPATCH_EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from configurable_spectrograms_torch.render import dispatch

    return getattr(dispatch, name)


class Axes:
    """One grid cell of a :class:`SpectroFigure` (a matplotlib-Axes stand-in)."""

    def __init__(self, figure: "SpectroFigure", row: int, col: int):
        self.figure = figure
        self.row = row
        self.col = col
        self.panel: PanelData | None = None
        self.title: str | None = None
        self.title_fontsize_pt: float = AXIS_LABEL_PT
        self.xlabel: str | None = None
        self.ylabel: str | None = None
        self.ylabel_rotation: float = 90.0
        self.result: dict[str, Any] | None = None  # device outputs after render

    # -- matplotlib-parity setters -----------------------------------------

    def set_title(self, title: str, fontsize: float | None = None) -> None:
        self.title = title
        if fontsize is not None:
            self.title_fontsize_pt = float(fontsize)

    def set_xlabel(self, label: str) -> None:
        self.xlabel = label

    def set_ylabel(self, label: str, fontsize: float | None = None, rotation: float = 90, **kwargs) -> None:
        self.ylabel = label
        self.ylabel_rotation = rotation


class SpectroFigure:
    """A deferred-render figure; the matplotlib-Figure stand-in."""

    def __init__(self, figsize: tuple[float, float] = (6.25, 2.0), dpi: float = 100.0):
        self.figsize = figsize
        self.dpi = dpi
        self.nrows = 1
        self.ncols = 1
        self.axes: list[Axes] = []
        self._grid: dict[tuple[int, int], Axes] = {}
        self.suptitle_text: str | None = None
        self.suptitle_pt: float = AXIS_LABEL_PT + 2
        self.fig_texts: list[dict] = []
        self.bottom_reserve: float = 0.0  # figure-fraction bottom space
        self.number = None  # Gcf-compat attribute

    # -- construction --------------------------------------------------------

    def add_subplot(self, nrows: int, ncols: int, index: int) -> Axes:
        self.nrows, self.ncols = nrows, ncols
        row, col = divmod(index - 1, ncols)
        ax = Axes(self, row, col)
        self.axes.append(ax)
        self._grid[(row, col)] = ax
        return ax

    def suptitle(self, text: str, fontsize: float | None = None) -> None:
        self.suptitle_text = text
        if fontsize is not None:
            self.suptitle_pt = float(fontsize)

    def text(self, x: float, y: float, s: str, ha: str = "center", va: str = "bottom",
             fontsize: float = 13.0, color: str = "black", **kwargs) -> None:
        self.fig_texts.append({"x": x, "y": y, "s": s, "ha": ha, "va": va, "pt": fontsize, "color": color})

    def subplots_adjust(self, bottom: float | None = None, **kwargs) -> None:
        if bottom is not None:
            self.bottom_reserve = max(self.bottom_reserve, bottom)

    def tight_layout(self, rect: tuple | None = None) -> None:
        if rect is not None:
            self.bottom_reserve = max(self.bottom_reserve, rect[1])

    # -- rendering -----------------------------------------------------------

    def savefig(self, path: str, dpi: float | None = None, compress_level: int = 3) -> None:
        """Render and write a PNG (``compress_level``: the deflate level wherever the encoder deflates).

        One compute-gate slot spans render AND encode (the inner gates are
        re-entrant): releasing between the two would let a sibling worker
        start its composite mid-figure and steal interpreter slices from
        this one's encode.
        """
        from configurable_spectrograms_torch.utils.compute_gate import host_compute_gate

        with host_compute_gate():
            save_image(self.render(dpi=dpi), path, compress_level=compress_level)

    def render(self, dpi: float | None = None):
        return render_figures([self], dpi=dpi)[0]

    def clear(self) -> None:
        self.axes.clear()
        self._grid.clear()

    # matplotlib-compat aliases used by close_all_axes_and_clear
    def clf(self) -> None:
        self.clear()

    def delaxes(self, ax: Axes) -> None:
        if ax in self.axes:
            self.axes.remove(ax)


def save_image(image, path: str, compress_level: int = 3) -> None:
    """Write a rendered figure image: PNG through the native encoder, atomically, then paced writeback.

    A compositor image carries its numpy RGBA canvas (``_np_canvas``),
    which the encoder reads in place (it drops the alpha); any other image
    is converted to RGB first.  The PNG is encoded to a unique ``.tmp-*``
    sibling and renamed, so a kill mid-write never leaves a truncated PNG
    under its final name (the batch resume skips existing files).  Other
    formats go through PIL.
    """
    import threading

    import numpy as np

    from configurable_spectrograms_torch.render.fastpng import write_png_rgb
    from configurable_spectrograms_torch.utils.compute_gate import host_compute_gate
    from configurable_spectrograms_torch.utils.timing import active_stage
    from configurable_spectrograms_torch.utils.writeback import note_written

    is_png = path.lower().endswith(".png") or "." not in os.path.basename(path)
    if not is_png:
        fmt_needs_rgb = os.path.splitext(path)[1].lower() in (".jpg", ".jpeg", ".bmp")
        (image.convert("RGB") if fmt_needs_rgb and image.mode != "RGB" else image).save(path)
        return
    with host_compute_gate(), active_stage("png_encode"):
        arr = getattr(image, "_np_canvas", None)
        if arr is None:
            arr = np.asarray(image if image.mode == "RGB" else image.convert("RGB"))
        # Unique per writer: concurrent raw/given jobs may target the same
        # final name (the reference's documented write race).
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            write_png_rgb(arr, tmp, compress_level)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        note_written(path)


def render_figures(figures: list["SpectroFigure"], dpi: float | None = None) -> list:
    """Render many figures with their panels pooled into shared dispatches.

    Panels from every figure group by tile geometry, so an orbit's
    given/raw figure pair rasterizes in a couple of device programs.
    Returns one PIL image per figure.

    One gate slot spans the whole render.  It is yielded around the render
    of the panels only when that render blocks: when the coalescer hands
    it to its dispatcher thread.  With ``CST_RENDER_COALESCE=0`` the
    render runs inline on this thread, host compute included, and keeps
    the slot.
    """
    from configurable_spectrograms_torch.render.service import coalesced_render, coalescing
    from configurable_spectrograms_torch.utils.compute_gate import gate_released, host_compute_gate
    from configurable_spectrograms_torch.utils.timing import active_stage

    def _composite_one(layout):
        # Re-entrant under the outer gate; still gates direct callers.
        with host_compute_gate(), active_stage("composite"):
            return layout.composite()

    with host_compute_gate():
        layouts = [_Layout(fig, float(dpi or fig.dpi)) for fig in figures]
        by_tile: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for f_i, (fig, layout) in enumerate(zip(figures, layouts)):
            for a_i, ax in enumerate(fig.axes):
                ax.result = None
                if ax.panel is not None:
                    by_tile.setdefault((layout.tile_h, layout.tile_w), []).append((f_i, a_i))
        for (tile_h, tile_w), slots in by_tile.items():
            panels = [figures[f_i].axes[a_i].panel for f_i, a_i in slots]
            with gate_released() if coalescing() else contextlib.nullcontext():
                results = coalesced_render(panels, tile_h, tile_w)
            for (f_i, a_i), res in zip(slots, results):
                figures[f_i].axes[a_i].result = res
        return [_composite_one(layout) for layout in layouts]
