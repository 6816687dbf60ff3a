"""Uniform affine quantization primitives (port of ``repro/core/quant.py``).

Asymmetric / symmetric uniform quantization on a ``2**bits`` grid with
nearest or stochastic rounding.  The arithmetic is the reference's, op for
op, so integer images are bit-equal:

  * the zero point comes from the range width (``255 * -qmin / width``),
    not from ``-qmin / scale`` — the latter lands an ulp either side of a
    .5 tie depending on how the division folds;
  * ``x / scale`` is a true division, never a reciprocal multiply;
  * ``torch.round`` rounds half to even, like ``jnp.round``.

The forward quantizers ``Q_W`` / ``Q_Y`` take the clipped straight-through
estimator: the gradient passes inside the grid's representable range
``[lo, hi]`` and is zero outside it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Minimum representable range width (degenerate ranges would otherwise
# give a zero scale and NaNs on dequantization).
_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantizer (hashable)."""

    bits: int = 8
    symmetric: bool = False
    stochastic: bool = False

    @property
    def num_levels(self) -> int:
        return 2 ** self.bits

    @property
    def int_min(self) -> int:
        return -(2 ** (self.bits - 1)) if self.symmetric else 0

    @property
    def int_max(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.symmetric else 2 ** self.bits - 1

    @property
    def storage_dtype(self) -> torch.dtype:
        """int8 for the symmetric grid, uint8 for the asymmetric one."""
        return torch.int8 if self.symmetric else torch.uint8


def _f32(v, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    dev = like.device if like is not None else None
    return torch.tensor(v, dtype=torch.float32, device=dev)


def scale_zero_point(qmin, qmax, spec: QuantSpec):
    """Map a real range ``[qmin, qmax]`` to fp32 ``(scale, zero_point)``."""
    like = qmin if isinstance(qmin, torch.Tensor) else (
        qmax if isinstance(qmax, torch.Tensor) else None)
    qmin = _f32(qmin, like)
    qmax = _f32(qmax, like)
    if spec.symmetric:
        amax = torch.maximum(qmin.abs(), qmax.abs())
        scale = (amax / float(2 ** (spec.bits - 1) - 1)).clamp(min=_EPS)
        zero_point = torch.zeros_like(scale)
    else:
        # Zero inside the range, so padding / ReLU zeros round-trip.
        qmin = qmin.clamp(max=0.0)
        qmax = qmax.clamp(min=0.0)
        levels = float(spec.num_levels - 1)
        scale = ((qmax - qmin) / levels).clamp(min=_EPS)
        width = (qmax - qmin).clamp(min=_EPS)
        zero_point = torch.round((levels * (-qmin)) / width)
        zero_point = zero_point.clamp(0.0, levels)
    return scale, zero_point


def quantize(x: torch.Tensor, qmin, qmax, spec: QuantSpec,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integer image (int32) of ``x`` on the grid of ``[qmin, qmax]``;
    ``noise`` in ``[0, 1)`` selects stochastic rounding."""
    scale, zp = scale_zero_point(qmin, qmax, spec)
    v = x.to(torch.float32) / scale + zp
    if spec.stochastic:
        if noise is None:
            raise ValueError("stochastic rounding requires a `noise` tensor")
        q = torch.floor(v + noise)
    else:
        q = torch.round(v)
    q = q.clamp(float(spec.int_min), float(spec.int_max))
    return q.to(torch.int32)


def dequantize(q: torch.Tensor, qmin, qmax, spec: QuantSpec) -> torch.Tensor:
    scale, zp = scale_zero_point(qmin, qmax, spec)
    return (q.to(torch.float32) - zp) * scale


def fake_quant_raw(x: torch.Tensor, qmin, qmax, spec: QuantSpec,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """quantize -> dequantize (no gradient definition)."""
    q = quantize(x, qmin, qmax, spec, noise)
    if spec.bits <= 8:
        q = q.to(spec.storage_dtype)
    return dequantize(q, qmin, qmax, spec).to(x.dtype)


def ste_mask(x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
             spec: QuantSpec) -> torch.Tensor:
    """True where ``x`` lies inside the grid's representable range
    ``[(int_min - zp) * scale, (int_max - zp) * scale]``: where the clipped
    STE passes the gradient."""
    lo = (float(spec.int_min) - zero_point) * scale
    hi = (float(spec.int_max) - zero_point) * scale
    xf = x.to(torch.float32)       # compare in fp32, as the reference does
    return (xf >= lo) & (xf <= hi)


class _OnGrid(torch.autograd.Function):
    """The on-grid values of ``x`` from its integer image ``q`` and the
    registers; backward is the clipped STE: the cotangent of ``x`` is the
    incoming one masked to the grid's ``[lo, hi]``."""

    @staticmethod
    def forward(ctx, x, q, scale, zero_point, spec, dtype):
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(ste_mask(x, scale, zero_point, spec))
        return ((q.to(torch.float32) - zero_point) * scale).to(dtype)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return (torch.where(mask, g, 0.0).to(g.dtype),
                None, None, None, None, None)


def on_grid(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            zero_point: torch.Tensor, spec: QuantSpec,
            dtype=None) -> torch.Tensor:
    """``dequantize`` of the image ``q`` of ``x`` (in ``dtype``, default
    ``x``'s), with the clipped-STE gradient to ``x``."""
    return _OnGrid.apply(x, q, scale, zero_point, spec, dtype or x.dtype)


def fake_quant_ste(x: torch.Tensor, qmin, qmax, spec: QuantSpec
                   ) -> torch.Tensor:
    """Fake-quant with the clipped straight-through gradient."""
    qmin, qmax = _f32(qmin, x), _f32(qmax, x)
    q = quantize(x.detach(), qmin, qmax, spec)
    if spec.bits <= 8:
        q = q.to(spec.storage_dtype)
    scale, zp = scale_zero_point(qmin, qmax, spec)
    return on_grid(x, q, scale, zp, spec)


def tensor_minmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-tensor fp32 ``(min, max)``; ``(+inf, -inf)`` of an empty
    tensor (a model rank's empty share: neutral in a min/max)."""
    if x.numel() == 0:
        inf = torch.tensor(float("inf"), device=x.device)
        return inf, -inf
    mn, mx = torch.aminmax(x.to(torch.float32))
    return mn, mx


def quant_error(x: torch.Tensor, qmin, qmax, spec: QuantSpec) -> torch.Tensor:
    """Mean-squared quantization error of ``x`` on a candidate range (for
    range search and diagnostics)."""
    y = fake_quant_raw(x, qmin, qmax, spec)
    return torch.mean((x.to(torch.float32) - y.to(torch.float32)) ** 2)


def cosine_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - cos(a, b); the DSGC objective."""
    af = a.to(torch.float32).reshape(-1)
    bf = b.to(torch.float32).reshape(-1)
    num = torch.dot(af, bf)
    den = (torch.linalg.norm(af) * torch.linalg.norm(bf)).clamp(min=_EPS)
    return 1.0 - num / den


def cosine_from_sums(dot: torch.Tensor, sq_a: torch.Tensor,
                     sq_b: torch.Tensor) -> torch.Tensor:
    """1 - cos(a, b) from the sums ``a.b``, ``|a|^2`` and ``|b|^2`` (the
    DSGC objective of a tensor whose pieces sum them on several ranks)."""
    den = (torch.sqrt(sq_a) * torch.sqrt(sq_b)).clamp(min=_EPS)
    return 1.0 - dot / den
