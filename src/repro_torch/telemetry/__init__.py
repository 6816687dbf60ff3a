"""Telemetry (port of ``repro.telemetry``).  Only the configuration that
the quantization policy needs is ported so far; telemetry stays disabled,
so every stats vector is width 3."""
from .config import DISABLED, TelemetryConfig  # noqa: F401
