"""Synthetic data streams (port of ``repro.data``)."""
from .pipeline import ImageStream, LMStream, for_arch  # noqa: F401
