"""Explicit guard-trigger event records (port of
``repro/telemetry/events.py``).

:class:`GuardEventDetector` re-evaluates the guard's own decision rule on
the per-step counters the state carries, so every event it emits is an
in-step guard action:

  * the state's telemetry slots hold this step's aggregated counters, so
    the detector sees the same ``clip_rate > clip_threshold`` predicate
    the guard saw;
  * the previous step's streak is the detector's remembered record, so
    ``streak + 1 >= patience`` reproduces the trigger, and the post-update
    streak confirms it (widen resets it to 0, dynamic holds it at
    ``>= patience``).

Event record (embedded in the JSONL step line under ``"events"``):

    {"site": "<site path>", "step": <int>,
     "action": "widen" | "fallback_enter" | "fallback_exit",
     "old": [qmin, qmax], "new": [qmin, qmax],
     "clip_rate": <float>, "streak": <float>}

Exact when the detector sees every optimizer step (``--telemetry-every
1``) and the site is visited each step.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .config import GUARD_DYNAMIC, GUARD_WIDEN, TelemetryConfig


def _widen_kinds():
    """Estimator kinds whose update applies the widen action (import
    deferred: ``repro_torch.core`` imports this package)."""
    from repro_torch.core import estimators
    return (estimators.HINDSIGHT, estimators.RUNNING, estimators.DSGC)


def _site_family(site: str) -> str:
    """'act' or 'grad' from a site path like 'decoder/blocks/b0/up/act[3]'."""
    leaf = site.rsplit("/", 1)[-1]
    return leaf.split("[", 1)[0]


class GuardEventDetector:
    """Stateful host-side detector: feed it each step's collected records
    (:func:`repro_torch.telemetry.collect`) in order; it returns the guard
    events that fired in that step's update."""

    def __init__(self, tcfg: TelemetryConfig, policy=None):
        self.tcfg = tcfg
        # Without a policy assume widen-capable (the hindsight setting).
        self._kinds = {"act": None, "grad": None}
        if policy is not None:
            self._kinds = {"act": policy.act_estimator.kind,
                           "grad": policy.grad_estimator.kind}
        self._prev: Dict[str, Dict[str, float]] = {}

    def _widen_capable(self, site: str) -> bool:
        kind = self._kinds.get(_site_family(site))
        return kind is None or kind in _widen_kinds()

    def update(self, step: int,
               records: Dict[str, Dict[str, float]]) -> List[dict]:
        events: List[dict] = []
        tcfg = self.tcfg
        if tcfg.guard:
            for site, rec in records.items():
                if "clip_rate" not in rec:
                    continue  # width-3 record: telemetry slots absent
                prev = self._prev.get(site)
                prev_streak = prev["streak"] if prev else 0.0
                prev_range = ([prev["qmin"], prev["qmax"]] if prev
                              else [rec["qmin"], rec["qmax"]])
                clipping = rec["clip_rate"] > tcfg.clip_threshold
                would = prev_streak + 1.0 if clipping else 0.0
                ev: Optional[dict] = None
                if tcfg.mode == GUARD_WIDEN:
                    if (would >= tcfg.patience and rec["streak"] == 0.0
                            and self._widen_capable(site)):
                        ev = {"action": "widen"}
                elif tcfg.mode == GUARD_DYNAMIC:
                    if prev_streak < tcfg.patience \
                            and rec["streak"] >= tcfg.patience:
                        ev = {"action": "fallback_enter"}
                    elif prev_streak >= tcfg.patience \
                            and rec["streak"] < tcfg.patience:
                        ev = {"action": "fallback_exit"}
                if ev is not None:
                    ev.update({
                        "site": site, "step": int(step),
                        "old": [float(v) for v in prev_range],
                        "new": [float(rec["qmin"]), float(rec["qmax"])],
                        "clip_rate": float(rec["clip_rate"]),
                        "streak": float(rec["streak"]),
                    })
                    events.append(ev)
        self._prev = records
        return events
