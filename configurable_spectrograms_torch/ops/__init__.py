"""Spectrogram math on torch tensors: kernels and the eager panel analysis.

The public names are those of the JAX package's ``ops``.  They resolve on
first use, so importing a module of this package (``ops._build`` for one)
does not import torch.  The JAX package's XLA compilation cache has no
counterpart here.
"""

import importlib

_EXPORTS = {
    "AVAILABLE_COLORMAPS": "_colormap_data",
    "colormap_lut": "_colormap_data",
    "RenderSpec": "spectrogram",
    "collapse_cube": "spectrogram",
    "masked_nanpercentile": "spectrogram",
    "quantize_matrix": "spectrogram",
    "render_matrix": "spectrogram",
    "render_panels": "spectrogram",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
