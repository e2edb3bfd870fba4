"""Panel dispatch, host backend, and figure composition.

The public names are those of the JAX package's ``render``.  They resolve
on first use, so importing a module of this package (``render.tile`` for
one) does not import torch, and importing the package starts no CUDA.
"""

import importlib

_EXPORTS = {
    "Axes": "figure",
    "PanelData": "figure",
    "SpectroFigure": "figure",
    "device_render_panels": "figure",
    "close_all_axes_and_clear": "plotting",
    "generic_plot_multirow_optional_zoom": "plotting",
    "generic_plot_spectrogram_set": "plotting",
    "make_spectrogram": "plotting",
    "TimeWindow": "tile",
    "compute_time_window": "tile",
    "make_x_map": "tile",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
