"""Architecture registry (port of ``repro.configs``)."""
from .arch import ArchConfig, get, get_reduced, names  # noqa: F401
