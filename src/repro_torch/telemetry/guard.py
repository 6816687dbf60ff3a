"""Overflow guard (port of ``repro/telemetry/guard.py``): the in-step
policy reacting to sustained clipping.

After ``patience`` consecutive optimizer steps with a site's clipped
fraction above ``clip_threshold``:

  * ``widen`` mode replaces the state range by the union of the EMA and
    observed ranges, expanded by ``widen_factor`` (one-shot, stays
    static);
  * ``dynamic`` mode makes ``estimators.ranges`` fall back to current
    min-max while the streak persists, until the EMA range re-contains the
    observed range within ``recover_margin`` (simulated backend only).

All functions are elementwise over the last axis.
"""
from __future__ import annotations

import torch

from .config import (
    GUARD_DYNAMIC,
    GUARD_WIDEN,
    INITED,
    QMAX,
    QMIN,
    T_STREAK,
    TelemetryConfig,
)
from .metrics import clip_rate

_EPS = 1e-12


def drift(leaf: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
    """How far this step's observed range moved relative to the
    (pre-update) EMA range width; 0 for unvisited or uninitialized
    sites."""
    w = torch.clamp(leaf[..., QMAX] - leaf[..., QMIN], min=_EPS)
    d = torch.maximum(torch.abs(stat[..., QMIN] - leaf[..., QMIN]),
                      torch.abs(stat[..., QMAX] - leaf[..., QMAX])) / w
    live = torch.logical_and(stat[..., INITED] > 0.5, leaf[..., INITED] > 0.5)
    return torch.where(live, d, torch.zeros_like(d))


def in_fallback(tcfg: TelemetryConfig, leaf: torch.Tensor) -> torch.Tensor:
    """True while a ``dynamic``-mode guard has this site on current
    min-max ranges."""
    return leaf[..., T_STREAK] >= tcfg.patience


def update_streak(tcfg: TelemetryConfig, leaf: torch.Tensor,
                  stat: torch.Tensor, visited: torch.Tensor,
                  dynamic_capable: bool = True) -> torch.Tensor:
    """Next streak value from this step's aggregated stats: consecutive
    steps over the clip threshold, held (not reset) while a dynamic-mode
    fallback is active and the EMA range does not yet contain the observed
    one.  ``dynamic_capable`` is False for estimators whose ``ranges`` has
    no dynamic fallback (their streak is a metric only)."""
    streak = leaf[..., T_STREAK]
    clipping = clip_rate(stat) > tcfg.clip_threshold
    zero = torch.zeros_like(streak)
    if tcfg.mode == GUARD_DYNAMIC and dynamic_capable:
        w = torch.clamp(leaf[..., QMAX] - leaf[..., QMIN], min=_EPS)
        m = tcfg.recover_margin * w
        contained = torch.logical_and(stat[..., QMIN] >= leaf[..., QMIN] - m,
                                      stat[..., QMAX] <= leaf[..., QMAX] + m)
        hold = torch.logical_and(in_fallback(tcfg, leaf),
                                 torch.logical_not(contained))
        new = torch.where(clipping, streak + 1.0,
                          torch.where(hold, streak, zero))
    else:
        new = torch.where(clipping, streak + 1.0, zero)
    return torch.where(visited, new, streak)


def apply_widen(tcfg: TelemetryConfig, stat: torch.Tensor,
                qmin: torch.Tensor, qmax: torch.Tensor,
                streak: torch.Tensor):
    """``widen``-mode trigger: on ``streak >= patience`` replace the
    (post-EMA) range by the union of the EMA and observed ranges expanded
    by ``widen_factor``, and reset the streak.  Returns ``(qmin, qmax,
    streak)``; a no-op in ``dynamic`` mode or with the guard disarmed."""
    if not (tcfg.guard and tcfg.mode == GUARD_WIDEN):
        return qmin, qmax, streak
    trigger = streak >= tcfg.patience
    lo = torch.minimum(qmin, stat[..., QMIN])
    hi = torch.maximum(qmax, stat[..., QMAX])
    margin = 0.5 * (tcfg.widen_factor - 1.0) * torch.clamp(hi - lo, min=_EPS)
    qmin = torch.where(trigger, lo - margin, qmin)
    qmax = torch.where(trigger, hi + margin, qmax)
    streak = torch.where(trigger, torch.zeros_like(streak), streak)
    return qmin, qmax, streak
