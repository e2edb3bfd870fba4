"""Cusp-boundary markers composited onto rendered panels.

Three interchangeable styles matching the reference's
(reference cusp_marking.py:11-185): ``line`` draws a thick black underlay
with a thinner colored overlay through the data; ``bracket`` draws a
bracket spanning the marked interval below the axis; ``both`` draws both.
Coordinates arrive in axes-pixel space (the figure compositor converts
data positions); widths are in points and scale with DPI like matplotlib
line widths.
"""

from __future__ import annotations

from configurable_spectrograms_torch.render.text import draw_text, pt_to_px

CUSP_MARKER_STYLES = ("line", "bracket", "both")


def draw_cusp_line_markers(
    draw,
    axes_rect: tuple[int, int, int, int],
    marker_px: list[float],
    dpi: float,
    line_color: str = "red",
    **kwargs,
) -> None:
    """Vertical 4pt black underlay + 2pt colored overlay at each marker.

    Mirrors reference cusp_marking.py:11-46; extra kwargs are accepted and
    ignored so one style-kwargs dict serves every marker style.
    """
    x0, y0, x1, y1 = axes_rect
    w_black = max(1, pt_to_px(4, dpi))
    w_color = max(1, pt_to_px(2, dpi))
    for px in marker_px:
        cx = x0 + px
        if not (x0 <= cx <= x1):
            continue
        draw.line([(cx, y0), (cx, y1)], fill="black", width=w_black)
        draw.line([(cx, y0), (cx, y1)], fill=line_color, width=w_color)


def draw_cusp_bracket_marker(
    draw,
    axes_rect: tuple[int, int, int, int],
    marker_px: list[float],
    dpi: float,
    color: str = "black",
    bracket_y: float = -0.08,
    bracket_tick_height: float = 0.02,
    caption: str | None = None,
    caption_offset: float = 0.04,
    caption_fontsize: float | None = None,
    linewidth: float = 1.5,
    **kwargs,
) -> None:
    """Bracket spanning the marked interval below the axis.

    ``bracket_y``/``bracket_tick_height``/``caption_offset`` are in axes
    fraction (negative = below the axis), matching reference
    cusp_marking.py:48-154.  A single marker degenerates to one tick.
    """
    if not marker_px:
        return
    x0, y0, x1, y1 = axes_rect
    h = y1 - y0
    lw = max(1, pt_to_px(linewidth, dpi))
    # Axes-fraction y -> pixel y (fraction 0 = bottom of axes = y1).
    def fy(frac: float) -> float:
        return y1 - frac * h

    if len(marker_px) == 1:
        cx = x0 + marker_px[0]
        draw.line([(cx, fy(0.0)), (cx, fy(bracket_y))], fill=color, width=lw)
        caption_x = cx
    else:
        start = x0 + min(marker_px)
        end = x0 + max(marker_px)
        top = fy(bracket_y + bracket_tick_height)
        bar = fy(bracket_y)
        draw.line([(start, top), (start, bar)], fill=color, width=lw)
        draw.line([(start, bar), (end, bar)], fill=color, width=lw)
        draw.line([(end, bar), (end, top)], fill=color, width=lw)
        caption_x = 0.5 * (start + end)
    if caption:
        px = pt_to_px(caption_fontsize if caption_fontsize is not None else 10, dpi)
        draw_text(draw, (caption_x, fy(bracket_y - caption_offset)), caption, px, fill=color, anchor="ma")


def draw_cusp_both_markers(draw, axes_rect, marker_px, dpi, **kwargs) -> None:
    """Line + bracket together (reference cusp_marking.py:157-185)."""
    draw_cusp_line_markers(draw, axes_rect, marker_px, dpi, **kwargs)
    draw_cusp_bracket_marker(draw, axes_rect, marker_px, dpi, **kwargs)


CUSP_MARKER_DRAWERS = {
    "line": draw_cusp_line_markers,
    "bracket": draw_cusp_bracket_marker,
    "both": draw_cusp_both_markers,
}
