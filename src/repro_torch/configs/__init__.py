"""Architecture registry (port of ``repro.configs``): ``configs.get(name)``
/ ``configs.get_reduced``, and the shape matrix (``SHAPES``, ``cells``,
``input_specs``)."""
from .arch import (  # noqa: F401
    SHAPES,
    ArchConfig,
    Cell,
    ShapeSpec,
    cells,
    get,
    get_reduced,
    input_specs,
    names,
)
