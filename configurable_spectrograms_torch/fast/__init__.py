"""FAST mission layer: the extrema pre-pass and the per-orbit render."""
