"""Quantized linear algebra with the paper's training data path (port of
``repro/core/qlinear.py``).

A quantized matmul site: ``x_q = Q_Y(x)`` (activation estimator),
``w_q = Q_W(w)`` (current min-max, symmetric), ``y = x_q @ w_q (+ b)`` as
an int8 x int8 -> int32 contraction, and ``y`` tagged with the gradient
barrier, whose backward quantizes the cotangent (``Q_G``, stochastic
rounding, in-hindsight range).

Range state: activation sites emit their observed statistics in the
forward pass; gradient sites emit theirs through the *cotangent channel*:
the barrier's backward returns the statistics vector as the gradient of
the site's state leaf, so ``torch.autograd.grad`` over the grad leaves
delivers them.  The estimator update runs once per optimizer step
(:func:`update_quant_state`).

Under a model group (``runtime.sharding.model_parallel``) a site names
the dim of its tensor that a model rank holds a slice of (``x_dim`` of an
input, ``y_dim`` of an output; None: the tensor is whole on every rank),
and a product its form (``parallel``: ``"col"``, ``"row"``,
``"expert"``, see ``backend.qmatmul``), whose weight is this rank's
shard.  Under the sequence-parallel residual (``sharding.seq_rows``) a
product that leaves or enters it names the row dim (``seq_dim``): a
``"row"`` product's output, its gradient site and its bias add are the
rank's rows of the input's (gathered) rows; a ``"col"`` product's input
cotangent is reduce-scattered onto them.  Outside one they change
nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.telemetry import metrics

from repro_torch.runtime import sharding

from . import backend, estimators, quant
from .backend import QTensor  # noqa: F401  (re-exported for site callers)
from .policy import QuantPolicy
from .state import INITED, QMAX, QMIN, init_range_state, tree_map, \
    tree_map_with_path


# ---------------------------------------------------------------------------
# Q_W: weight quantizer — current min-max, no state.
# ---------------------------------------------------------------------------
def quantize_weight(w: torch.Tensor, policy: QuantPolicy,
                    sharded: bool = False, transpose: bool = False
                    ) -> torch.Tensor:
    """On-grid weight values (fp32; ``w`` itself when not quantized)."""
    wq, wqt = quantize_weight_q(w, policy, sharded, transpose)
    if wq is None:
        wq = backend.dequantize_qtensor(wqt)
    return wq


def quantize_weight_q(w: torch.Tensor, policy: QuantPolicy,
                      sharded: bool = False, transpose: bool = False
                      ) -> tuple[Optional[torch.Tensor], Optional[QTensor]]:
    """``(w, None)`` when weights are not quantized, else ``(wq,
    qtensor)``.  ``wq`` (on-grid values with the clipped-STE gradient) is
    ``None`` unless a gradient of ``w`` is being recorded: an inference
    contraction reads the int8 image only and never materializes them.
    ``sharded``: ``w`` is a model rank's shard, quantized on the whole
    weight's range.  ``transpose``: the weight is ``w.T`` (a tied head
    reads ``embed``).

    A stored leaf (``sharding.stored_of``, ZeRO-3) is gathered here, at
    its use: with ``int8_weight_gather`` its share is quantized on the
    whole weight's (min, max) and the int8 image moves
    (:class:`_GatheredSTE`); otherwise the fp share is gathered
    (``sharding.unstore``) and the whole quantized as before.  Either
    way the gradient is reduce-scattered onto the share."""
    if not (policy.enabled and policy.quantize_weights):
        w = sharding.unstore(w)
        return (w.T if transpose else w), None
    if policy.int8_weight_gather and policy.weight_spec.bits <= 8:
        st = sharding.stored_of(w)
        if st is not None and not st.axes:
            st = None
        mn, mx = sharding.stored_minmax(*quant.tensor_minmax(w.detach()), st)
        if sharded and "model" not in getattr(st, "axes", ()):
            mn, mx = sharding.mp_minmax(mn, mx)
        y = _GatheredSTE.apply(w, mn, mx, policy.weight_spec, st)
        return (y.T if transpose else y), None
    w = sharding.unstore(w)
    return backend.weight_quantize(policy, w.T if transpose else w, sharded)


class _GatheredSTE(torch.autograd.Function):
    """The weight's fake-quant whose int8 image is gathered before it is
    dequantized (the reference's ``_fake_quant_ste_gathered``): a stored
    share (``st``, ZeRO-3) is quantized on the whole weight's range, its
    1-byte image all-gathered into the compute shard's
    (``sharding.gather_stored``), and the gradient reduce-scattered onto
    the share (``sharding.scatter_stored``); a replicated weight's image
    is only pinned (:func:`sharding.replicate_hint`).  Numerically the
    fake-quant; the clipped STE backward (gradient masked to the grid's
    ``[lo, hi]``, on the share: the mask is elementwise)."""

    @staticmethod
    def forward(ctx, x, qmin, qmax, spec, st=None):
        q = quant.quantize(x, qmin, qmax, spec).to(spec.storage_dtype)
        q = sharding.replicate_hint(q) if st is None else \
            sharding.gather_stored(q, st)
        y = quant.dequantize(q, qmin, qmax, spec).to(x.dtype)
        scale, zp = quant.scale_zero_point(qmin, qmax, spec)
        lo = (spec.int_min - zp) * scale
        hi = (spec.int_max - zp) * scale
        xf = x.detach().to(torch.float32)
        ctx.save_for_backward(torch.logical_and(xf >= lo, xf <= hi))
        ctx.st = st
        return y

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        if ctx.st is not None:
            g = sharding.scatter_stored(g, ctx.st).to(g.dtype)
        return torch.where(mask, g, 0.0).to(g.dtype), None, None, None, None


# ---------------------------------------------------------------------------
# Q_Y: activation quantizer site.
# ---------------------------------------------------------------------------
def stats_zeros(policy: QuantPolicy, device=None) -> torch.Tensor:
    """A "site not visited" stats vector of the policy's stat width."""
    return torch.zeros((policy.stat_width,), dtype=torch.float32,
                       device=device)


def act_quant_site(x: torch.Tensor, leaf: torch.Tensor, policy: QuantPolicy,
                   step, model_dim: Optional[int] = None
                   ) -> tuple[torch.Tensor, torch.Tensor, Optional[QTensor]]:
    """``(x_q, observed stats, qtensor)``; ``qtensor`` is ``None`` when
    activation quantization is off.  ``model_dim``: the dim of ``x`` a
    model rank holds a slice of (None: whole)."""
    if not (policy.enabled and policy.quantize_acts):
        return x, stats_zeros(policy, x.device), None
    return backend.act_quantize(policy, x, leaf, step, model_dim)


class _GradBarrier(torch.autograd.Function):
    """Identity forward; backward quantizes the cotangent and returns the
    observed statistics as the gradient of ``leaf`` (the cotangent
    channel)."""

    @staticmethod
    def forward(ctx, y, leaf, policy, seed, step, batch_dim, model_dim):
        ctx.save_for_backward(leaf)
        ctx.policy, ctx.seed, ctx.step = policy, seed, step
        ctx.batch_dim, ctx.model_dim = batch_dim, model_dim
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        (leaf,) = ctx.saved_tensors
        gq, stats = backend.grad_quantize(ctx.policy, g, leaf, ctx.seed,
                                          ctx.step, ctx.batch_dim,
                                          ctx.model_dim)
        return gq, stats, None, None, None, None, None


def grad_quant_barrier(y: torch.Tensor, leaf: torch.Tensor,
                       policy: QuantPolicy, seed: int, step,
                       batch_dim: int = 0,
                       model_dim: Optional[int] = None) -> torch.Tensor:
    """Identity in the forward pass; quantizes the cotangent in the backward
    pass and emits the observed (min, max) as the gradient of ``leaf``.
    Read it with ``torch.autograd.grad`` over a leaf that requires grad —
    never accumulate into ``.grad``: torch sums repeated gradients, while
    statistics combine by min/max (:func:`combine_stats`).  ``batch_dim``:
    the dim of ``y`` that a data-parallel rank holds a shard of (the MoE
    experts' ``[E, G, C, F]`` outputs shard their groups, dim 1), and
    ``model_dim`` the one a model rank does (None: whole)."""
    if not (policy.enabled and policy.quantize_grads):
        return y
    return _GradBarrier.apply(y, leaf, policy, int(seed), step, batch_dim,
                              model_dim)


# ---------------------------------------------------------------------------
# Site containers and matmul sites.
# ---------------------------------------------------------------------------
def init_site(policy: Optional[QuantPolicy] = None, device=None) -> dict:
    """State for one quantized matmul: activation-in + grad-out leaves."""
    width = 3 if policy is None else policy.stat_width
    return {"act": init_range_state(width, device),
            "grad": init_range_state(width, device)}


def _contract(policy, espec, xq, xqt, w, bias, dtype, batch_dim=0,
              parallel=None, seq_dim=None):
    wq, wqt = quantize_weight_q(w, policy, sharded=parallel is not None
                                and sharding.mp_shard() is not None)
    if wq is not None:
        wq = wq.to(dtype)
    y = backend.qmatmul(policy, espec, xq, xqt, wq, wqt, batch_dim=batch_dim,
                        parallel=parallel, seq_dim=seq_dim)
    if bias is not None:
        if _exits_rows(parallel, seq_dim):
            # added on the rank's rows: its gradient summed over the group
            bias = sharding.mp_grad_sum(bias)
        y = y + bias.to(dtype)
    return y


def _exits_rows(parallel, seq_dim) -> bool:
    """Whether a product's output is the rank's rows of the sequence."""
    return parallel == "row" and seq_dim is not None and \
        sharding.mp_shard() is not None


def _out_dim(x, parallel, seq_dim, y_dim):
    """The gradient site's model dim: a row exit's rows, named with the
    whole size (the noise is the whole site's, sliced)."""
    if _exits_rows(parallel, seq_dim):
        return (seq_dim, x.shape[seq_dim])
    return y_dim


def qdense_pre(xq: torch.Tensor, w: torch.Tensor, site: dict,
               policy: QuantPolicy, *, einsum_spec: str = "...k,kn->...n",
               bias: Optional[torch.Tensor] = None, seed=0, step=0,
               qinfo: Optional[QTensor] = None, batch_dim: int = 0,
               parallel: Optional[str] = None,
               y_dim: Optional[int] = None,
               seq_dim: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Quantized matmul whose input was already quantized by a shared
    activation site; ``qinfo`` is that site's :class:`QTensor`."""
    y = _contract(policy, einsum_spec, xq, qinfo, w, bias, xq.dtype,
                  batch_dim, parallel, seq_dim)
    y = grad_quant_barrier(y, site["grad"], policy, seed, step, batch_dim,
                           _out_dim(xq, parallel, seq_dim, y_dim))
    z = stats_zeros(policy, xq.device)
    return y, {"act": z, "grad": z.clone()}


def qdense(x: torch.Tensor, w: torch.Tensor, site: dict,
           policy: QuantPolicy, *, bias: Optional[torch.Tensor] = None,
           seed=0, step=0, parallel: Optional[str] = None,
           x_dim: Optional[int] = None, y_dim: Optional[int] = None,
           seq_dim: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Quantized ``x @ w (+ bias)``; returns ``(y, stats)``."""
    xq, act_stats, xqt = act_quant_site(x, site["act"], policy, step, x_dim)
    y = _contract(policy, "...k,kn->...n", xq, xqt, w, bias, x.dtype,
                  parallel=parallel, seq_dim=seq_dim)
    y = grad_quant_barrier(y, site["grad"], policy, seed, step,
                           model_dim=_out_dim(x, parallel, seq_dim, y_dim))
    return y, {"act": act_stats, "grad": stats_zeros(policy, x.device)}


def qeinsum(spec: str, x: torch.Tensor, w: torch.Tensor, site: dict,
            policy: QuantPolicy, *, seed=0, step=0, batch_dim: int = 0,
            parallel: Optional[str] = None, x_dim: Optional[int] = None,
            y_dim: Optional[int] = None,
            seq_dim: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Quantized einsum for non-2D contractions (attention projections)."""
    xq, act_stats, xqt = act_quant_site(x, site["act"], policy, step, x_dim)
    y = _contract(policy, spec, xq, xqt, w, None, x.dtype, batch_dim,
                  parallel, seq_dim)
    y = grad_quant_barrier(y, site["grad"], policy, seed, step, batch_dim,
                           _out_dim(x, parallel, seq_dim, y_dim))
    return y, {"act": act_stats, "grad": stats_zeros(policy, x.device)}


# ---------------------------------------------------------------------------
# State plumbing.
# ---------------------------------------------------------------------------
def merge_stats(fwd_stats, cot_stats):
    """Merge the forward (activation) stats tree with the cotangent-channel
    (gradient) stats tree into one tree shaped like the quant state."""
    return tree_map(combine_stats, fwd_stats, cot_stats)


def combine_stats(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two observations of one site: min of mins, max of maxes,
    visited-or, each side masked by its own visited flag.  Width-10
    vectors also sum the clip/n/err/sig counters and max-combine the
    util/drift/streak slots."""
    av = a[..., INITED] > 0.5
    bv = b[..., INITED] > 0.5
    big = 3.4e38
    amin = torch.where(av, a[..., QMIN], big)
    bmin = torch.where(bv, b[..., QMIN], big)
    amax = torch.where(av, a[..., QMAX], -big)
    bmax = torch.where(bv, b[..., QMAX], -big)
    visited = torch.maximum(a[..., INITED], b[..., INITED])
    mn = torch.where(visited > 0.5, torch.minimum(amin, bmin), 0.0)
    mx = torch.where(visited > 0.5, torch.maximum(amax, bmax), 0.0)
    base = torch.stack([mn, mx, visited], dim=-1)
    if a.shape[-1] == 3:
        return base
    sums, maxes = metrics.combine_tail(a, b)
    return torch.cat([base, sums, maxes], dim=-1)


def update_quant_state(policy: QuantPolicy, quant_state, stats):
    """One estimator update per site; the leaf's dict key ("act" /
    "grad") picks the estimator."""
    def upd(path, leaf, st):
        kind = next((p for p in reversed(path) if p in ("act", "grad")),
                    None)
        cfg = policy.act_estimator if kind == "act" else policy.grad_estimator
        return estimators.update(cfg, leaf, st, telemetry=policy.telemetry)

    return tree_map_with_path(upd, quant_state, stats)


def zero_stats_like(state):
    return tree_map(torch.zeros_like, state)
