"""Synthetic data streams (port of ``repro.data``)."""
from .pipeline import LMStream, for_arch  # noqa: F401
