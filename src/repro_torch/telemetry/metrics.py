"""In-step telemetry metrics (port of ``repro/telemetry/metrics.py``).

Everything here runs inside the quantization sites (the forward
activation quantizer and the gradient barrier's backward), on the site's
device: a handful of elementwise compares and reductions over a sampled
prefix of the tensor, stacked into the width-10 stats vector in one op.
"""
from __future__ import annotations

import dataclasses

import torch

from .config import (
    BASE_WIDTH,
    QMAX,
    QMIN,
    T_CLIP,
    T_ERR,
    T_N,
    T_SIG,
    T_UTIL,
)

_EPS = 1e-12


def _prefix(x: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` elements of ``x`` in its logical (row-major) order
    (``x.reshape(-1)[:n]``), copying at most the leading rows that hold
    them: a permuted view is never flattened whole."""
    if x.is_contiguous():
        return x.view(-1)[:n]
    while x.dim() > 1 and x[0].numel() >= n:
        x = x[0]
    inner = x[0].numel() if x.dim() > 1 else 1
    return x[:-(-n // inner)].reshape(-1)[:n]


def site_stats(x: torch.Tensor, used_qmin: torch.Tensor,
               used_qmax: torch.Tensor, spec, base: torch.Tensor,
               sample: int = 4096) -> torch.Tensor:
    """Extend a width-3 stats vector with the site's telemetry counters.

    ``x`` is the tensor being quantized, ``[used_qmin, used_qmax]`` the
    range the quantizer applied, ``spec`` its ``QuantSpec`` and ``base``
    the ``[obs_min, obs_max, 1.0]`` vector from ``estimators.stats``.  The
    clip/err/sig counters run on the first ``sample`` elements of ``x``
    (``sample=0``: all of them), cast to fp32 after slicing, and are
    scaled to the full size; the quantized image is recomputed on that
    prefix with nearest rounding.  Counters are raw (scaled) sums, so they
    combine across microbatches by addition."""
    from repro_torch.core import quant as _q

    size = x.numel()
    x = x.detach()
    if 0 < sample < size:
        xs = _prefix(x, sample).to(torch.float32)
        scale = size / sample
    else:
        xs, scale = x.reshape(-1).to(torch.float32), 1.0
    clipped = torch.sum(torch.logical_or(xs < used_qmin, xs > used_qmax)
                        .to(torch.float32))
    det_spec = dataclasses.replace(spec, stochastic=False)
    qs = _q.fake_quant_raw(xs, used_qmin, used_qmax, det_spec)
    err = torch.sum(torch.square(xs - qs)) * scale
    sig = torch.sum(torch.square(xs)) * scale
    used_w = torch.clamp(used_qmax - used_qmin, min=_EPS)
    util = (base[QMAX] - base[QMIN]) / used_w
    zero = torch.zeros_like(util)
    tail = torch.stack([clipped * scale, torch.full_like(util, float(size)),
                        err, sig, util, zero,   # T_DRIFT: filled by update()
                        zero])                  # T_STREAK: state-only slot
    return torch.cat([base, tail])


def combine_tail(a: torch.Tensor, b: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine the telemetry slots of two observations of one site:
    ``(sums, maxes)``, the additive counters (clip/n/err/sig) and the
    max-combined slots (util/drift/streak)."""
    sums = a[..., T_CLIP:T_UTIL] + b[..., T_CLIP:T_UTIL]
    maxes = torch.maximum(a[..., T_UTIL:], b[..., T_UTIL:])
    return sums, maxes


def widen_state(tree, width: int):
    """Pad every width-3 state leaf of ``tree`` to ``width`` with zeros
    (the model builders make width-3 leaves; a telemetry-enabled policy
    widens them here, once)."""
    if width == BASE_WIDTH:
        return tree
    from repro_torch.core.state import tree_map

    def pad(leaf):
        if leaf.shape[-1] == width:
            return leaf
        return torch.nn.functional.pad(leaf, (0, width - leaf.shape[-1]))

    return tree_map(pad, tree)


# Derived helpers shared by the host side and the tests.
def clip_rate(stat: torch.Tensor) -> torch.Tensor:
    return stat[..., T_CLIP] / torch.clamp(stat[..., T_N], min=1.0)


def sqnr_db(stat: torch.Tensor) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB (capped at 99 for
    err = 0)."""
    sig = torch.clamp(stat[..., T_SIG], min=_EPS)
    err = torch.clamp(stat[..., T_ERR], min=_EPS)
    return torch.clamp(10.0 * torch.log10(sig / err), max=99.0)
