"""Telemetry configuration (port of ``repro/telemetry/config.py``).

Stdlib only.  With ``enabled=False`` (the default) every per-site
state/stats vector is the classic width-3 ``[qmin, qmax, inited]``; with
telemetry enabled it is width 10:

  idx  name      meaning                                     microbatch combine
  ---  --------  ------------------------------------------  ------------------
   0   QMIN      observed min (stats) / EMA min (state)      masked min
   1   QMAX      observed max (stats) / EMA max (state)      masked max
   2   INITED    visited flag (stats) / inited flag (state)  or
   3   T_CLIP    #elements outside the range used            sum
   4   T_N       #elements observed                          sum
   5   T_ERR     sum of squared quantization error           sum
   6   T_SIG     sum of squared signal (SQNR numerator)      sum
   7   T_UTIL    observed-width / used-width utilization     max
   8   T_DRIFT   |observed vs EMA range| / EMA width         max
   9   T_STREAK  consecutive over-threshold steps (state)    max
"""
from __future__ import annotations

import dataclasses

# Base slots (must match repro_torch.core.state.QMIN/QMAX/INITED).
QMIN, QMAX, INITED = 0, 1, 2

# Telemetry slots.
T_CLIP, T_N, T_ERR, T_SIG, T_UTIL, T_DRIFT, T_STREAK = 3, 4, 5, 6, 7, 8, 9

BASE_WIDTH = 3
TELEMETRY_WIDTH = 10

GUARD_WIDEN = "widen"
GUARD_DYNAMIC = "dynamic"
GUARD_MODES = (GUARD_WIDEN, GUARD_DYNAMIC)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry + overflow-guard configuration (same fields and
    validation as the reference)."""

    enabled: bool = False
    guard: bool = False
    clip_threshold: float = 0.01
    patience: int = 3
    widen_factor: float = 1.5
    recover_margin: float = 0.05
    mode: str = GUARD_WIDEN
    sample: int = 4096

    def __post_init__(self):
        if self.mode not in GUARD_MODES:
            raise ValueError(f"unknown guard mode {self.mode!r}")
        if self.patience < 1:
            raise ValueError("patience must be >= 1")
        if self.widen_factor < 1.0:
            raise ValueError("widen_factor must be >= 1.0")

    @property
    def stat_width(self) -> int:
        return TELEMETRY_WIDTH if self.enabled else BASE_WIDTH


DISABLED = TelemetryConfig()
