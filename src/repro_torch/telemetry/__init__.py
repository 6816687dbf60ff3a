"""Quantization telemetry and the overflow guard (port of
``repro.telemetry``).

Per-site clip rate, range utilization, range drift and SQNR ride the same
channels as the min/max statistics (the forward stats tree for activation
sites, the cotangent channel for gradient sites), combine exactly across
grad-accum microbatches, and reach the host once per step.

  * :mod:`.config`  — ``TelemetryConfig`` and the width-10 slot layout.
  * :mod:`.metrics` — in-step counters at the quantization sites and the
    microbatch combine rule.
  * :mod:`.guard`   — the overflow guard (``widen`` / ``dynamic``).
  * :mod:`.sinks`   — ``collect`` (one host transfer) and the JSONL ring
    and in-memory sinks.
  * :mod:`.events`  — explicit guard-trigger event records.
  * :mod:`.trace`   — host-side spans and the ``StepTimer`` step phases.
  * :mod:`.report`  — ``python -m repro_torch.telemetry.report``.
"""
from .config import (  # noqa: F401
    BASE_WIDTH,
    DISABLED,
    GUARD_DYNAMIC,
    GUARD_MODES,
    GUARD_WIDEN,
    T_CLIP,
    T_DRIFT,
    T_ERR,
    T_N,
    T_SIG,
    T_STREAK,
    T_UTIL,
    TELEMETRY_WIDTH,
    TelemetryConfig,
)
from .events import GuardEventDetector  # noqa: F401
from .metrics import clip_rate, site_stats, sqnr_db, widen_state  # noqa: F401
from .sinks import (  # noqa: F401
    SCHEMA_VERSION,
    JsonlSink,
    MemorySink,
    collect,
    read_jsonl,
    read_jsonl_full,
    read_jsonl_records,
)
from .trace import StepTimer, Tracer  # noqa: F401
from . import trace  # noqa: F401
