"""Models (port of ``repro.models``): the dense LM family for serving."""
