"""Panel inputs, per-panel results, and the numpy host group render.

Port of ``render/panel.py`` plus the result builder of ``render/drain.py``:
:class:`PanelData` is the unit every backend renders,
:class:`LazyPanelResult` the result the compositor blits, and
:func:`_render_group_host` the parity-tested numpy group renderer behind
``CST_RENDER_BACKEND=host``.  Besides the scalars, every result carries
the quantized index rows it was built from (``idx``, with ``idx_rows``
naming the matrix row of each), so the two backends can be compared
cell by cell.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from configurable_spectrograms_torch.ops._colormap_data import colormap_lut
from configurable_spectrograms_torch.render.tile import (
    TimeWindow,
    make_x_map,
    resample_indices,
)


def _bucket(n: int, step: int, minimum: int) -> int:
    return max(minimum, int(math.ceil(n / step)) * step)


@dataclass
class PanelData:
    """Everything needed to rasterize and decorate one spectrogram panel."""

    cube: np.ndarray  # (T, A, E) float32, collapse axis already at 1
    pitch_mask: np.ndarray  # (A,) bool
    energy: np.ndarray  # (E,)
    times: np.ndarray  # (T,) x values (unix seconds or raw)
    window: TimeWindow
    y_min: float
    y_max: float
    z_min: float | None
    z_max: float | None
    y_scale: str
    z_scale: str
    colormap: str
    x_is_unix: bool
    z_label: str
    vertical_lines: list[float] = field(default_factory=list)
    cusp_marker_style: str = "both"
    cusp_marker_kwargs: dict = field(default_factory=dict)
    line_color: str = "red"
    low_percentile: float = 1.0
    high_percentile: float = 99.0
    #: Optional override of the energy range used only for percentile color
    #: bounds (y_min, y_max), pooled over the full file's rows -- the FAST
    #: grids' bound rule (reference fast/plotting.py:118-134).
    bounds_energy_range: tuple[float, float] | None = None


class LazyPanelResult(dict):
    """Panel result whose ``"rgba"`` tile materializes on first access.

    The production compositor never needs the standalone tile: it blits
    into a figure-canvas rect, so :meth:`draw_rgba_into` resamples the
    quantized index matrix straight into that view (via
    ``resample_indices(out=...)``), skipping the intermediate
    (tile_h, tile_w, 4) allocation plus one full write+read of it per
    panel (~22 MB of canvas-sized traffic per 8-panel figure).  Direct
    consumers -- tests, embedders, the service API -- still read
    ``result["rgba"]`` and get the identical tile, rendered lazily and
    cached.  Scalars (vmin/vmax/y0/y1/n_kept/empty) stay eager.
    """

    def __init__(self, fields: dict, render):
        super().__init__(fields)
        self._render = render  # render(out=None) -> tile or out

    def __missing__(self, key):
        if key == "rgba":
            tile = self._render()
            self["rgba"] = tile
            # The cached tile fully replaces the renderer; dropping it
            # releases the captured quantized-index row (and anything else
            # the closure holds) instead of pinning it for the result's
            # lifetime.
            self._render = None
            return tile
        raise KeyError(key)

    def __contains__(self, key) -> bool:
        return key == "rgba" or dict.__contains__(self, key)

    def get(self, key, default=None):
        if key == "rgba":
            return self["rgba"]
        return dict.get(self, key, default)

    # Enumeration must see the full mapping (consumers copy results via
    # items()/dict(...)): materialize the tile first so laziness stays an
    # invisible optimization, not a behavior change.
    def _materialize(self) -> None:
        if not dict.__contains__(self, "rgba"):
            self["rgba"]

    def keys(self):
        self._materialize()
        return dict.keys(self)

    def values(self):
        self._materialize()
        return dict.values(self)

    def items(self):
        self._materialize()
        return dict.items(self)

    def __iter__(self):
        self._materialize()
        return dict.__iter__(self)

    def __len__(self) -> int:
        self._materialize()
        return dict.__len__(self)

    def copy(self):
        self._materialize()
        return dict(self)

    # Mutating/compare operations must also see the full mapping: an eager
    # result dict would return the tile from pop("rgba"), keep setdefault
    # from shadowing it, and compare equal to its dict copy.
    def pop(self, key, *default):
        self._materialize()
        return dict.pop(self, key, *default)

    def popitem(self):
        self._materialize()
        return dict.popitem(self)

    def setdefault(self, key, default=None):
        self._materialize()
        return dict.setdefault(self, key, default)

    def __eq__(self, other):
        self._materialize()
        if isinstance(other, LazyPanelResult):
            other._materialize()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        result = self.__eq__(other)
        return result if result is NotImplemented else not result

    __hash__ = None  # same as dict: unhashable

    def draw_rgba_into(self, view: "np.ndarray") -> None:
        """Composite this panel into *view* (an RGBA canvas rect)."""
        if dict.__contains__(self, "rgba"):
            view[...] = self["rgba"][: view.shape[0], : view.shape[1]]
        else:
            self._render(out=view)


def build_panel_result(p: PanelData, idx_j: np.ndarray, meta_j: np.ndarray, idx_rows: np.ndarray,
                       pre_gathered: bool, tile_h: int, tile_w: int, y_scale: str, z_scale: str):
    """One panel's result from its device index rows and float32 metadata.

    ``meta_j`` is ``[n_kept, flip, y0, y1, vmin, vmax, empty, kept_pos...]``
    (the layout of ``render/drain.py``).  Explicit log bounds whose safe
    floor exceeds vmax are an error, recorded per panel and raised when
    the owning figure composites (matplotlib's LogNorm raises there).
    """
    n_kept_j, flip_j, y0_j, y1_j, vmin_j, vmax_j, empty_j = meta_j[:7]
    if z_scale == "log" and not bool(empty_j) and vmin_j > vmax_j:
        return {"error": "minvalue must be less than or equal to maxvalue"}

    def _render(out=None):
        return resample_indices(
            idx_j, meta_j[7:].astype(np.int32), int(meta_j[0]), bool(meta_j[1]),
            float(meta_j[2]), float(meta_j[3]), p.window.t_start, p.window.t_count,
            make_x_map(p.window, tile_w), tile_h, tile_w, y_scale, colormap_lut(p.colormap),
            empty=bool(meta_j[6]), pre_gathered=pre_gathered, out=out,
        )

    return LazyPanelResult(
        {
            "vmin": float(vmin_j),
            "vmax": float(vmax_j),
            "y0": float(y0_j),
            "y1": float(y1_j),
            "n_kept": int(n_kept_j),
            "empty": bool(empty_j),
            "idx": idx_j,
            "idx_rows": idx_rows,
        },
        _render,
    )


def _render_group_host(panels: list[PanelData], idxs: list[int], tile_h: int, tile_w: int,
                       y_scale: str, z_scale: str, lo_pct: float, hi_pct: float,
                       results: list) -> None:
    """Pure-numpy group rasterization (``CST_RENDER_BACKEND=host``)."""
    from configurable_spectrograms_torch.render.host_quantize import (
        cached_collapse,
        host_clean,
        host_quantize,
    )

    # The shared NaN pass per cube runs at most once per group, and only
    # if some mask actually misses the cross-render collapse cache.
    clean_cache: dict[int, np.ndarray] = {}

    def _clean_for(cube):
        def provider():
            c = clean_cache.get(id(cube))
            if c is None:
                c = clean_cache[id(cube)] = host_clean(cube)
            return c

        return provider

    for i in idxs:
        p = panels[i]
        matrix = cached_collapse(p.cube, p.pitch_mask, _clean_for(p.cube))
        e_valid = (p.energy >= p.y_min) & (p.energy <= p.y_max)
        if p.bounds_energy_range is not None:
            b_lo, b_hi = p.bounds_energy_range
            zb_e_valid = (p.energy >= b_lo) & (p.energy <= b_hi)
            zb_full = True
        else:
            zb_e_valid, zb_full = None, False
        try:
            q = host_quantize(
                matrix, p.energy, e_valid, p.window.t_start, p.window.t_count,
                (p.z_min, p.z_max), y_scale, z_scale, lo_pct, hi_pct, zb_e_valid, zb_full,
            )
        except ValueError as exc:
            # Per-panel analysis error (inverted log bounds): recorded and
            # raised by the owning figure's composite, not here.
            results[i] = {"error": str(exc)}
            continue

        def _render(out=None, _q=q, _p=p):
            return resample_indices(
                _q["idx"], _q["kept_pos"], _q["n_kept"], _q["flip"], _q["y0"], _q["y1"],
                _p.window.t_start, _p.window.t_count, make_x_map(_p.window, tile_w),
                tile_h, tile_w, y_scale, colormap_lut(_p.colormap), empty=_q["empty"],
                out=out,
            )

        results[i] = LazyPanelResult(
            {
                "vmin": q["vmin"],
                "vmax": q["vmax"],
                "y0": q["y0"],
                "y1": q["y1"],
                "n_kept": q["n_kept"],
                "empty": q["empty"],
                "idx": q["idx"],
                "idx_rows": np.arange(q["idx"].shape[0]),
            },
            _render,
        )
