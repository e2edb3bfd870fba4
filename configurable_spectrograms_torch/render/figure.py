"""Figure/axes model with deferred, batched rasterization (port of ``render/figure.py``).

A :class:`SpectroFigure` mirrors the slice of the matplotlib
``Figure``/``Axes`` API the reference's pipelines touch, but nothing
rasterizes until :meth:`SpectroFigure.savefig`/:meth:`render`: the figure
only accumulates :class:`PanelData` descriptions.  :func:`render_figures`
pools the panels of many figures into the bucketed dispatch
(:func:`..render.dispatch.render_panels`) and the PIL compositor draws
frames, ticks, labels, colorbars, cusp markers and titles around the tiles.
PIL is imported only by the composite and the PNG write.
"""

from __future__ import annotations

import os
from typing import Any

from configurable_spectrograms_torch.render.compositor import AXIS_LABEL_PT, _Layout
from configurable_spectrograms_torch.render.dispatch import render_panels
from configurable_spectrograms_torch.render.panel import PanelData


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
        """Render and write a PNG (``compress_level`` is PIL's zlib level)."""
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
    """Write a rendered figure image; PNG writes are atomic.

    A PNG is encoded to a unique ``.tmp-*`` sibling and then renamed, so a
    kill mid-write never leaves a truncated PNG under its final name.
    """
    import threading

    is_png = path.lower().endswith(".png") or "." not in os.path.basename(path)
    if not is_png:
        fmt_needs_rgb = os.path.splitext(path)[1].lower() in (".jpg", ".jpeg", ".bmp")
        (image.convert("RGB") if fmt_needs_rgb and image.mode != "RGB" else image).save(path)
        return
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        img = image if image.mode == "RGB" else image.convert("RGB")
        img.save(tmp, format="PNG", compress_level=compress_level)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def render_figures(figures: list["SpectroFigure"], dpi: float | None = None) -> list:
    """Render many figures with their panels pooled into shared dispatches.

    Panels from every figure group by tile geometry, so an orbit's
    given/raw figure pair rasterizes in a couple of device programs.
    Returns one PIL image per figure.
    """
    layouts = [_Layout(fig, float(dpi or fig.dpi)) for fig in figures]
    by_tile: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for f_i, (fig, layout) in enumerate(zip(figures, layouts)):
        for a_i, ax in enumerate(fig.axes):
            ax.result = None
            if ax.panel is not None:
                by_tile.setdefault((layout.tile_h, layout.tile_w), []).append((f_i, a_i))
    for (tile_h, tile_w), slots in by_tile.items():
        panels = [figures[f_i].axes[a_i].panel for f_i, a_i in slots]
        for (f_i, a_i), res in zip(slots, render_panels(panels, tile_h, tile_w)):
            figures[f_i].axes[a_i].result = res
    return [layout.composite() for layout in layouts]
