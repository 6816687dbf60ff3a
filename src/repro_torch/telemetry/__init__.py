"""Telemetry (port of ``repro.telemetry``).  Ported so far: the
configuration that the quantization policy needs (telemetry stays
disabled, so every stats vector is width 3) and the host-side step
tracer (``trace``)."""
from .config import DISABLED, TelemetryConfig  # noqa: F401
