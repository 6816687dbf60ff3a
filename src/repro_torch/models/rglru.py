"""RG-LRU recurrent block (port of ``repro/models/rglru.py``: Griffin /
RecurrentGemma, arXiv:2402.19427).

The recurrence is a diagonal (per-channel) gated linear RNN:

    r_t = sigmoid(W_a x_t + b_a)             (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)             (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block structure (Griffin "recurrent block"):

    x -> [linear in] -> temporal conv1d (width 4) -> RG-LRU ----\\
    x -> [linear gate] -> gelu ------------------------------- (*) -> [linear out]

The five projections' sites (``in``, ``gate``, ``a``, ``x``, ``out``) are
quantized as in the reference, two shared input quantizations among
them; the conv, the gates and the recurrence run in fp32, plain PyTorch
(the reference's ``jnp`` code, outside any kernel).  Decode carries
``(h, conv_tail)`` as constant-size state.

Under a model group (``runtime.sharding.model_parallel``) the block is
channel-parallel, as the reference's hint keeps it: a rank holds its
``C / M`` channels of ``lru_width`` (``w_in`` / ``w_gate`` columns,
``w_out`` rows, the conv taps, the gate biases and ``lambda``), and the
conv, the gates, the scan and the state run on them.  ``w_a`` and
``w_x`` hold the rank's input channels (``[C / M, C]``): their products
sum the ranks' int32 K-shard partials before the epilogue, every rank
gets the whole ``[B, S, C]`` gate input, and takes its channels
(``sharding.mp_take``: the gradient site then sees the whole cotangent
on every rank, gathered).  ``w_out`` is row-parallel, the output whole.

:func:`rglru_scan` evaluates the recurrence as ``jax.lax.associative_scan``
does: the same odd/even recursion over ``(a, b)`` pairs (about ``2 log2
S`` levels of vectorised ops), so its products and sums are the
reference's, in its order, and autograd through it is the train step's
backward.  The gates write each of the reference's ops: ``softplus`` as
``jnp.logaddexp(x, 0)`` computes it (no threshold), ``sqrt(1 - a^2)`` from
``log a``.  The reference's ``hint`` (the channel axis over the model
mesh axis) is called at its place (``runtime.sharding``; the model axis
is realized by the channel shards above).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.runtime import sharding

from .layers import activation, init_normal

_C = 8.0
_CONV_W = 4


def init_rglru(gen: torch.Generator, d_model: int, lru_width: int,
               dtype=torch.float32) -> dict:
    """The reference's shapes, dtypes and scales; ``conv_w``, the biases
    and ``lambda`` are fp32, ``lambda`` the inverse softplus of ``-log(a)
    / c`` for ``a^2`` uniform in ``(0.9^2, 0.999^2)`` (paper app. A)."""
    dev = gen.device
    f32 = torch.float32
    lo, hi = 0.9 ** 2, 0.999 ** 2
    lam = torch.rand((lru_width,), generator=gen, device=dev,
                     dtype=f32) * (hi - lo) + lo
    lam = torch.log(torch.expm1(-torch.log(lam) / _C))
    s = d_model ** -0.5
    return {
        "w_in": init_normal(gen, (d_model, lru_width), s, dtype),
        "w_gate": init_normal(gen, (d_model, lru_width), s, dtype),
        "w_out": init_normal(gen, (lru_width, d_model), lru_width ** -0.5,
                             dtype),
        "conv_w": init_normal(gen, (_CONV_W, lru_width), 0.1, f32),
        "conv_b": torch.zeros((lru_width,), dtype=f32, device=dev),
        "w_a": init_normal(gen, (lru_width, lru_width), lru_width ** -0.5,
                           dtype),
        "b_a": torch.zeros((lru_width,), dtype=f32, device=dev),
        "w_x": init_normal(gen, (lru_width, lru_width), lru_width ** -0.5,
                           dtype),
        "b_x": torch.zeros((lru_width,), dtype=f32, device=dev),
        "lambda": lam,
    }


def init_rglru_sites(device=None) -> dict:
    return {n: qlinear.init_site(device=device)
            for n in ("in", "gate", "out", "a", "x")}


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   tail: Optional[torch.Tensor] = None):
    """x ``[B, S, C]``; w ``[W, C]`` depthwise; tail ``[B, W-1, C]`` the
    carried context.  Accumulates in fp32 tap by tap as the reference;
    returns ``(out in x's dtype, new tail [B, W-1, C])``."""
    bsz, s, c = x.shape
    if tail is None:
        tail = torch.zeros((bsz, _CONV_W - 1, c), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    out = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for i in range(_CONV_W):
        out = out + xp[:, i:i + s].to(torch.float32) * w[i]
    return (out + b).to(x.dtype), xp[:, -(_CONV_W - 1):]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``[e0, o0, e1, o1, ...]`` along axis 1; ``even`` is as long as
    ``odd`` or one longer."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat(
        [pairs, even[:, n:]], dim=1)


def _scan(a: torch.Tensor, b: torch.Tensor):
    """``jax.lax.associative_scan``'s recursion (``_scan`` in jax's
    ``lax/control_flow/loops.py``) over axis 1 with the combine
    ``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a1, b1, a2, b2 = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _scan(a2 * a1, a2 * b1 + b2)
    if n % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    ya, yb = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], ya * pa], dim=1)
    even_b = torch.cat([b[:, :1], ya * pb + yb], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1.  a, b ``[B, S, C]`` fp32;
    h0 ``[B, C]`` the initial state."""
    if h0 is not None:
        b = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    return _scan(a, b)[1]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp(x, 0)``'s ops: ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def apply_rglru(params, sites: dict, x: torch.Tensor, *,
                policy: QuantPolicy, seed, step, state=None,
                seq_dim: Optional[int] = None):
    """x ``[B, S, D]``; ``state = (h [B, C] fp32, conv_tail [B, 3, C])`` or
    ``None``.  Returns ``(y, stats, (h, conv_tail))``.  ``seq_dim``: ``x``
    is the ranks' rows gathered along it (the conv and the scan need the
    whole sequence) and ``y`` this rank's rows (the sequence-parallel
    residual)."""
    s = x.shape[1]
    new_sites = {}
    # the model axis: the rank's channels (the last dim of u, gate, y)
    tp = sharding.mp_shard() is not None
    col, row, cdim = ("col", "row", -1) if tp else (None, None, None)
    # shared input quantization for in/gate; range state on the "in" site
    xq, in_stats, xqi = qlinear.act_quant_site(x, sites["in"]["act"],
                                               policy, step)
    u, s_in = qlinear.qdense_pre(xq, params["w_in"], sites["in"], policy,
                                 seed=seed, step=step, qinfo=xqi,
                                 parallel=col, y_dim=cdim, seq_dim=seq_dim)
    s_in["act"] = in_stats
    new_sites["in"] = s_in
    gate, new_sites["gate"] = qlinear.qdense_pre(
        xq, params["w_gate"], sites["gate"], policy, seed=seed + 1,
        step=step, qinfo=xqi, parallel=col, y_dim=cdim, seq_dim=seq_dim)
    h0, tail = (None, None) if state is None else state
    u, new_tail = _causal_conv1d(u, params["conv_w"], params["conv_b"], tail)

    # shared quantization of the conv output for the two gate projections
    uq, u_stats, uqi = qlinear.act_quant_site(u, sites["a"]["act"], policy,
                                              step, cdim)
    ra, s_a = qlinear.qdense_pre(uq, params["w_a"], sites["a"], policy,
                                 seed=seed + 2, step=step, qinfo=uqi,
                                 parallel=row)
    s_a["act"] = u_stats
    new_sites["a"] = s_a
    rx, new_sites["x"] = qlinear.qdense_pre(
        uq, params["w_x"], sites["x"], policy, seed=seed + 3, step=step,
        qinfo=uqi, parallel=row)
    ra, rx = sharding.mp_take(ra, -1), sharding.mp_take(rx, -1)
    f32 = torch.float32
    r = torch.sigmoid(ra.to(f32) + params["b_a"])
    i = torch.sigmoid(rx.to(f32) + params["b_x"])
    log_a = -_C * _softplus(params["lambda"]) * r          # [B, S, C] fp32
    # the recurrence is channel-parallel: C over the model axis
    log_a = sharding.hint(log_a, "batch", None, "model")
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via log: 1 - exp(2 log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i * u.to(f32))

    if s == 1 and h0 is not None:
        h = a[:, 0] * h0 + b[:, 0]
        hs = h[:, None]
    else:
        hs = rglru_scan(a, b, h0)
        h = hs[:, -1]

    y = hs.to(x.dtype) * activation(gate.to(f32), "gelu").to(x.dtype)
    out, new_sites["out"] = qlinear.qdense(y, params["w_out"], sites["out"],
                                           policy, seed=seed + 4, step=step,
                                           parallel=row, x_dim=cdim,
                                           seq_dim=seq_dim)
    return out, new_sites, (h, new_tail)
