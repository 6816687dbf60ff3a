"""Quantization-range estimators (port of ``repro/core/estimators.py``).

  ``current``    dynamic  min/max of the current tensor
  ``running``    dynamic  EMA of min/max including the current tensor
  ``hindsight``  STATIC   EMA of min/max of previous tensors only (the paper)
  ``dsgc``       hybrid   golden-section clipping search, re-run every
                          ``dsgc_interval`` steps
  ``fixed``      STATIC   constant range

Each estimator is a pair of functions over a state leaf
``[qmin, qmax, initialized]``: ``ranges`` (the range used now) and
``update`` (next step's state).  The ``observed=`` argument of ``ranges``
and ``stats`` takes min/max statistics the caller already has — on the
fused backend the quantize kernel's partials — so no second pass over the
tensor runs (the single-pass dataflow of paper Fig. 4).

With a telemetry-enabled policy the leaves are width 10
(``repro_torch.telemetry.config``): ``update`` writes the step's health
counters, the range drift and the guard streak, and fires the
``widen``-mode overflow guard; ``ranges`` honours the ``dynamic``-mode
fallback.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.runtime import sharding
from repro_torch.telemetry import config as tc
from repro_torch.telemetry import guard

from . import quant
from .state import INITED, QMAX, QMIN, pack_stats

CURRENT = "current"
RUNNING = "running"
HINDSIGHT = "hindsight"
DSGC = "dsgc"
FIXED = "fixed"

ALL_ESTIMATORS = (CURRENT, RUNNING, HINDSIGHT, DSGC, FIXED)
STATIC_ESTIMATORS = (HINDSIGHT, FIXED)


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Static estimator configuration for one tensor family."""

    kind: str = HINDSIGHT
    momentum: float = 0.9
    dsgc_interval: int = 100
    dsgc_iters: int = 20
    fixed_min: float = -1.0
    fixed_max: float = 1.0

    def __post_init__(self):
        if self.kind not in ALL_ESTIMATORS:
            raise ValueError(f"unknown estimator {self.kind!r}")

    @property
    def is_static(self) -> bool:
        return self.kind in STATIC_ESTIMATORS


def _telemetry_on(telemetry, leaf: torch.Tensor) -> bool:
    return (telemetry is not None and telemetry.enabled
            and leaf.shape[-1] > INITED + 1)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# DSGC range search (golden-section over a symmetric clipping threshold).
# ---------------------------------------------------------------------------
_GOLDEN = 0.6180339887498949


def dsgc_search(x: torch.Tensor, spec: quant.QuantSpec, iters: int = 20,
                split_model: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Golden-section search for the clipping value ``c`` minimizing
    ``1 - cos(x, Q(x; -c, c))`` on ``c in [0.05, 1] * max|x|``.

    ``x`` may be a rank's piece of the tensor: its rows under data
    parallelism (``sharding.data_parallel``), and its model shard where
    ``split_model`` (a site with a model dim).  The search then runs over
    the whole tensor: ``max|x|`` a max over those groups (exact), and the
    objective's three sums (x.y, |x|^2, |y|^2) partials summed over them,
    both probes' in one all_reduce an iteration.  Outside a group it is
    the one-process search, op for op."""
    xf = x.to(torch.float32)
    groups = sharding.site_groups(split_model)
    det_spec = dataclasses.replace(spec, stochastic=False)
    if not groups:
        amax = xf.abs().max().clamp(min=1e-8)

        def both(m1, m2):
            return tuple(quant.cosine_distance(
                xf, quant.fake_quant_raw(xf, -c, c, det_spec))
                for c in (m1, m2))
    else:
        amax = sharding.group_max(xf.abs().max() if xf.numel() else
                                  xf.new_zeros(()), groups).clamp(min=1e-8)
        flat = xf.reshape(-1)

        def both(m1, m2):
            parts = []
            for c in (m1, m2):
                y = quant.fake_quant_raw(xf, -c, c, det_spec).reshape(-1)
                parts += [torch.dot(flat, y), torch.dot(flat, flat),
                          torch.dot(y, y)]
            s = sharding.group_sum(torch.stack(parts), groups)
            return tuple(quant.cosine_from_sums(*s[i:i + 3])
                         for i in (0, 3))

    lo, hi = 0.05 * amax, amax
    for _ in range(iters):
        m1 = hi - _GOLDEN * (hi - lo)
        m2 = lo + _GOLDEN * (hi - lo)
        f1, f2 = both(m1, m2)
        lo, hi = torch.where(f1 < f2, lo, m1), torch.where(f1 < f2, m2, hi)
    c = 0.5 * (lo + hi)
    return -c, c


# ---------------------------------------------------------------------------
# ranges(): the range used to quantize the *current* tensor.
# ---------------------------------------------------------------------------
def ranges(cfg: EstimatorConfig, leaf: torch.Tensor, x: torch.Tensor,
           spec: quant.QuantSpec, step: Optional[int] = None,
           telemetry=None,
           observed: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
           split_model: bool = False
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Return the (qmin, qmax) the estimator prescribes for ``x``.  With
    ``observed`` given, no reduction of ``x`` runs.  ``split_model``:
    ``x`` is a model rank's shard (:func:`dsgc_search`)."""
    inited = leaf[INITED] > 0.5
    if cfg.kind == FIXED:
        return _const(cfg.fixed_min, leaf), _const(cfg.fixed_max, leaf)

    if cfg.kind == HINDSIGHT:
        # Static: the pre-computed range; the first batch falls back to
        # its own min/max (the paper's t=0 initialisation), and so does a
        # site the dynamic-mode guard holds in its fallback.
        mn, mx = observed if observed is not None else quant.tensor_minmax(x)
        use_static = inited
        if (_telemetry_on(telemetry, leaf) and telemetry.guard
                and telemetry.mode == "dynamic"):
            use_static = torch.logical_and(
                inited, torch.logical_not(guard.in_fallback(telemetry, leaf)))
        return (torch.where(use_static, leaf[QMIN], mn),
                torch.where(use_static, leaf[QMAX], mx))

    if cfg.kind == CURRENT:
        return observed if observed is not None else quant.tensor_minmax(x)

    if cfg.kind == RUNNING:
        mn, mx = observed if observed is not None else quant.tensor_minmax(x)
        eta = cfg.momentum
        qmin = torch.where(inited, eta * leaf[QMIN] + (1 - eta) * mn, mn)
        qmax = torch.where(inited, eta * leaf[QMAX] + (1 - eta) * mx, mx)
        return qmin, qmax

    if cfg.kind == DSGC:
        step = 0 if step is None else int(step)
        if not bool(inited) or step % cfg.dsgc_interval == 0:
            return dsgc_search(x, spec, cfg.dsgc_iters, split_model)
        return leaf[QMIN], leaf[QMAX]

    raise ValueError(cfg.kind)


def reads_current(cfg: EstimatorConfig, leaf: torch.Tensor,
                  telemetry=None) -> bool:
    """Whether :func:`ranges` takes this step's range from the tensor
    itself: a dynamic estimator, or a hindsight leaf on its first batch
    or held in the dynamic-mode guard's fallback (one host read of the
    leaf).  Otherwise the range is the leaf's and the tensor's (min, max)
    feed the statistics only."""
    if cfg.kind in (CURRENT, RUNNING, DSGC):
        return True
    if cfg.kind != HINDSIGHT:
        return False
    if not bool(leaf[INITED] > 0.5):
        return True
    return bool(_telemetry_on(telemetry, leaf) and telemetry.guard
                and telemetry.mode == "dynamic"
                and bool(guard.in_fallback(telemetry, leaf)))


def static_ranges(cfg: EstimatorConfig, leaf: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-computed (qmin, qmax) of a STATIC estimator: no tensor, no
    first-batch fallback, no reduction."""
    if cfg.kind == FIXED:
        return _const(cfg.fixed_min, leaf), _const(cfg.fixed_max, leaf)
    if cfg.kind == HINDSIGHT:
        return leaf[..., QMIN], leaf[..., QMAX]
    raise ValueError(
        f"static_ranges requires a static estimator, got {cfg.kind!r}")


# ---------------------------------------------------------------------------
# stats(): what the accumulator-side logic emits for the update.
# ---------------------------------------------------------------------------
def stats(cfg: EstimatorConfig, x: torch.Tensor, used_qmin: torch.Tensor,
          used_qmax: torch.Tensor,
          observed: Optional[tuple[torch.Tensor, torch.Tensor]] = None
          ) -> torch.Tensor:
    """Online statistics of the current tensor as a state-shaped vector."""
    if cfg.kind == DSGC:
        return pack_stats(used_qmin, used_qmax)
    mn, mx = observed if observed is not None else quant.tensor_minmax(x)
    return pack_stats(mn, mx)


# ---------------------------------------------------------------------------
# update(): fold the statistics into the next step's state.
# ---------------------------------------------------------------------------
def update(cfg: EstimatorConfig, leaf: torch.Tensor, stat: torch.Tensor,
           telemetry=None) -> torch.Tensor:
    """Next-step state from (previous state, this step's statistics);
    elementwise on the last axis.  Unvisited sites keep their state.

    At width 10 the returned state's telemetry slots carry this step's
    aggregated counters, the range drift and the guard streak, and the
    ``widen``-mode guard fires here."""
    visited = stat[..., INITED] > 0.5
    inited = leaf[..., INITED] > 0.5
    telemetry_on = _telemetry_on(telemetry, leaf)

    if cfg.kind == FIXED:
        if not telemetry_on:
            return leaf
        # Fixed ranges never move, but their counters still record.
        new_qmin, new_qmax = leaf[..., QMIN], leaf[..., QMAX]
    elif cfg.kind in (HINDSIGHT, RUNNING):
        eta = cfg.momentum
        new_qmin = torch.where(
            inited, eta * leaf[..., QMIN] + (1 - eta) * stat[..., QMIN],
            stat[..., QMIN])
        new_qmax = torch.where(
            inited, eta * leaf[..., QMAX] + (1 - eta) * stat[..., QMAX],
            stat[..., QMAX])
    elif cfg.kind in (CURRENT, DSGC):
        new_qmin, new_qmax = stat[..., QMIN], stat[..., QMAX]
    else:
        raise ValueError(cfg.kind)

    qmin = torch.where(visited, new_qmin, leaf[..., QMIN])
    qmax = torch.where(visited, new_qmax, leaf[..., QMAX])
    new_inited = torch.where(visited, torch.ones_like(leaf[..., INITED]),
                             leaf[..., INITED])
    if not telemetry_on:
        return torch.stack([qmin, qmax, new_inited], dim=-1)

    # The drift needs the pre-update leaf.  Guard actions apply only where
    # ranges() reads the leaf (widen: hindsight/running/dsgc; the dynamic
    # fallback: hindsight).
    dr = guard.drift(leaf, stat)
    streak = guard.update_streak(telemetry, leaf, stat, visited,
                                 dynamic_capable=(cfg.kind == HINDSIGHT))
    if cfg.kind in (HINDSIGHT, RUNNING, DSGC):
        qmin, qmax, streak = guard.apply_widen(telemetry, stat, qmin, qmax,
                                               streak)
    counters = torch.where(visited[..., None],
                           stat[..., tc.T_CLIP:tc.T_DRIFT],
                           leaf[..., tc.T_CLIP:tc.T_DRIFT])
    dr = torch.where(visited, dr, leaf[..., tc.T_DRIFT])
    return torch.cat([torch.stack([qmin, qmax, new_inited], dim=-1),
                      counters, torch.stack([dr, streak], dim=-1)], dim=-1)
