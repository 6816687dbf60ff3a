"""Synthetic data streams (port of ``repro.data``)."""
from .pipeline import (FrontendLMStream, ImageStream, LMStream,  # noqa: F401
                       for_arch)
