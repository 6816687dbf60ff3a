"""Drivers (port of ``repro.launch``): the serving driver so far."""
