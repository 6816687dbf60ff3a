"""Shared layers (port of ``repro/models/layers.py``): norms, rotary
embeddings, activations, the quantized MLP and the embedding.

Norms, rotary and activations compute in fp32 and cast back to the input
dtype, like the reference; every weight-bearing matmul goes through
:mod:`repro_torch.core.qlinear`.  Under a model group the MLP is a
Megatron pair: ``w_up`` / ``w_gate`` column-parallel (a rank's ``d_ff``
columns), ``w_down`` row-parallel; under the sequence-parallel residual
(``seq_dim``) the pair's input is the gathered rows and its output the
rank's rows (Megatron-SP), and a norm runs on the rank's rows.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.runtime import sharding


def init_normal(gen: torch.Generator, shape, scale: float, dtype
                ) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn on ``gen``'s device, cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    d = xf - mu
    var = torch.mean(d * d, dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def apply_norm(x: torch.Tensor, params, kind: str) -> torch.Tensor:
    """The residual stream's norm; under the sequence-parallel residual
    (``sharding.seq_rows``) ``x`` is the rank's rows, a norm is per row,
    and its parameters' gradients, partial sums over those rows, are
    summed over the model group."""
    scale, bias = params["scale"], params.get("bias")
    if sharding.seq_rows():
        scale = sharding.mp_grad_sum(scale)
        bias = None if bias is None else sharding.mp_grad_sum(bias)
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    return layernorm(x, scale, bias)


def init_norm(d: int, kind: str, use_bias: bool, device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm" and use_bias:
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: ``[B, S, *head_dims, Dh]``; positions: ``[B, S]``."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    expand = tuple(angles.shape[:2]) + (1,) * (x.ndim - 3) + (hd // 2,)
    cos = torch.cos(angles).reshape(expand)
    sin = torch.sin(angles).reshape(expand)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations.
# ---------------------------------------------------------------------------
def _in_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float (exact in fp32)."""
    return torch.tensor(v, dtype=torch.float64).to(dtype).item()


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu``'s tanh form, ``x * (0.5 * (1 + tanh(c * (x +
    0.044715 * x**3))))``, step by step in ``x``'s dtype with its constants
    rounded to that dtype as jnp's weak types are: bit-equal to the
    reference's written ops in bf16 (``F.gelu`` rounds once and differs in
    ~40% of bf16 elements), and in fp32 off only where XLA's ``tanh``
    approximation is (a few ulps).  The backward is JAX's vjp of the same
    form, op for op (``jax.make_jaxpr`` of ``jax.vjp(jax.nn.gelu, x)``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        c = _in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
        a = _in_dtype(0.044715, x.dtype)
        inner = c * (x + a * (x * x * x))
        return x * (0.5 * (1.0 + torch.tanh(inner)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c = _in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
        a = _in_dtype(0.044715, x.dtype)
        t = torch.tanh(c * (x + a * (x * x * x)))
        cdf = 0.5 * (1.0 + t)
        p = (0.5 * (x * g)) * (1.0 - t)
        s = c * (p + p * t)
        return (g * cdf + s) + (a * s) * (3.0 * (x * x))


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return _Gelu.apply(x)
    if kind == "silu":
        # jax.nn.silu is x * logistic(x).  XLA computes a bf16 logistic as
        # 1 / (1 + exp(-x)) with every step rounded to bf16, an fp32 one
        # as torch.sigmoid does; F.silu rounds differently in both.
        if x.dtype == torch.bfloat16:
            return x * (1 / (1 + torch.exp(-x)))
        return x * torch.sigmoid(x)
    if kind == "relu":
        return F.relu(x)
    if kind == "sq_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


GLU_KINDS = ("swiglu", "geglu", "reglu")
_GLU_ACT = {"swiglu": "silu", "geglu": "gelu", "reglu": "relu"}


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             use_bias: bool, dtype=torch.float32) -> dict:
    p = {"w_up": init_normal(gen, (d_model, d_ff), d_model ** -0.5, dtype),
         "w_down": init_normal(gen, (d_ff, d_model), d_ff ** -0.5, dtype)}
    if kind in GLU_KINDS:
        p["w_gate"] = init_normal(gen, (d_model, d_ff), d_model ** -0.5, dtype)
    if use_bias:
        p["b_up"] = torch.zeros((d_ff,), dtype=dtype, device=gen.device)
        p["b_down"] = torch.zeros((d_model,), dtype=dtype, device=gen.device)
    return p


def init_mlp_sites(kind: str, device=None) -> dict:
    sites = {"up": qlinear.init_site(device=device),
             "down": qlinear.init_site(device=device)}
    if kind in GLU_KINDS:
        sites["gate"] = qlinear.init_site(device=device)
    return sites


def apply_mlp(params, sites: dict, x: torch.Tensor, kind: str,
              policy: QuantPolicy, seed=0, step=0,
              seq_dim: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Returns ``(out, stats)``; one shared input quantization for up (and
    gate), its range state on the "up" site.  ``seq_dim``: ``x`` is the
    ranks' rows gathered along it and ``out`` this rank's rows (the
    sequence-parallel residual; ``qlinear``'s module docstring)."""
    new_sites = {}
    tp = sharding.mp_shard() is not None
    col, hdim = ("col", -1) if tp else (None, None)
    xq, in_stats, xqi = qlinear.act_quant_site(x, sites["up"]["act"], policy,
                                               step)
    up, s_up = qlinear.qdense_pre(xq, params["w_up"], sites["up"], policy,
                                  bias=params.get("b_up"), seed=seed,
                                  step=step, qinfo=xqi, parallel=col,
                                  y_dim=hdim, seq_dim=seq_dim)
    if kind in GLU_KINDS:
        gate, new_sites["gate"] = qlinear.qdense_pre(
            xq, params["w_gate"], sites["gate"], policy, seed=seed + 1,
            step=step, qinfo=xqi, parallel=col, y_dim=hdim, seq_dim=seq_dim)
        h = activation(gate, _GLU_ACT[kind]) * up
    else:
        h = activation(up, kind)
    s_up["act"] = in_stats
    new_sites["up"] = s_up
    out, new_sites["down"] = qlinear.qdense(
        h, params["w_down"], sites["down"], policy,
        bias=params.get("b_down"), seed=seed + 2, step=step,
        parallel="row" if tp else None, x_dim=hdim, seq_dim=seq_dim)
    return out, new_sites


# ---------------------------------------------------------------------------
# Embedding.
# ---------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32) -> torch.Tensor:
    return init_normal(gen, (vocab, d_model), d_model ** -0.5, dtype)
