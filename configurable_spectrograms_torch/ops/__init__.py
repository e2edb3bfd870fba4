"""Spectrogram math on torch tensors: kernels and the eager panel analysis."""
