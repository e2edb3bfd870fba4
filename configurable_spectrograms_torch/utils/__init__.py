"""Shared utilities: device selection, logging, progress persistence, percentiles."""
