"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``).

Shape plumbing (arbitrary-rank einsum -> batched 3-D matmul and back),
the pre-computed quant registers, and dispatch on where the operands lie:

  * CPU tensors   -> the kernel's plain PyTorch version,
  * CUDA tensors  -> the hand-written CUDA kernel (launched, or raises),
  * anything else -> raises.

There is no fallback between the two: a CUDA tensor never runs the plain
version here.  All wrappers return core-convention integers (uint8
asymmetric / int8 symmetric); the CUDA kernels write that convention
directly, so the reference's ``-128`` storage shift and its ``_unshift``
have no counterpart, and the elementwise quantize kernel runs on the flat
tensor, so no 2-D view (``_as_2d``) is needed either.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.quant import QuantSpec, scale_zero_point

from . import fused_quantize as _fq
from . import int8_attention as _attn
from . import int8_matmul as _mm
from . import stochastic_quantize as _sq
from .int8_attention import AttnSchedule

COUNTERS = (_fq.COUNTER, _mm.COUNTER, _attn.COUNTER, _sq.COUNTER,
            _mm.FUSED_COUNTER, _mm.TRANSPOSE_COUNTER)


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last reset."""
    return {c.name: c.count for c in COUNTERS}


def reset_launch_counts() -> None:
    for c in COUNTERS:
        c.count = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel operands must all lie on the CPU or all on "
                     f"a CUDA device; got {sorted(kinds)}")


def _qparams(qmin, qmax, spec: QuantSpec) -> torch.Tensor:
    """The (scale, zero_point) quant registers, computed exactly as the
    core quantizer does, as an fp32 ``[2]`` tensor."""
    scale, zp = scale_zero_point(qmin, qmax, spec)
    return torch.stack([scale, zp])


def fused_quantize(x: torch.Tensor, qmin, qmax, *,
                   spec: QuantSpec = QuantSpec(bits=8, symmetric=False)):
    """Single-pass static quantize + stats: ``(q, obs_min, obs_max)``."""
    qp = _qparams(qmin, qmax, spec).to(x.device)
    xf = x.to(torch.float32)
    if _on_cuda(xf, qp):
        return _fq.fused_quantize_cuda(xf, qp, spec)
    return _fq.fused_quantize_plain(xf, qp, spec)


def stochastic_quantize(x: torch.Tensor, qmin, qmax, noise, *,
                        spec: QuantSpec = QuantSpec(bits=8, symmetric=False,
                                                    stochastic=True),
                        on_chip_prng: bool = False, seed=None):
    """Gradient path: stochastic rounding onto a static in-hindsight grid.
    Returns ``(q, obs_min, obs_max)``.

    ``noise`` is the fp32 ``u in [0, 1)`` of ``x``'s shape.  With
    ``on_chip_prng=True`` the CUDA kernel draws ``u`` itself from its Philox
    stream keyed by ``seed`` and ``noise`` is ignored; only a CUDA tensor
    can take that form."""
    qp = _qparams(qmin, qmax, spec).to(x.device)
    xf = x.to(torch.float32)
    if on_chip_prng:
        if seed is None:
            raise ValueError("on_chip_prng=True requires a `seed`")
        if not _on_cuda(xf, qp):
            raise ValueError(
                "on_chip_prng=True draws its noise inside the CUDA kernel; "
                "a CPU tensor has no counterpart (pass the noise operand)")
        return _sq.stochastic_quantize_onchip_cuda(xf, qp, seed, spec)
    if noise is None:
        raise ValueError("stochastic rounding requires a `noise` tensor")
    nf = noise.to(torch.float32)
    if _on_cuda(xf, qp, nf):
        return _sq.stochastic_quantize_cuda(xf, qp, nf, spec)
    return _sq.stochastic_quantize_plain(xf, qp, nf, spec)


# ---------------------------------------------------------------------------
# Einsum plumbing.
# ---------------------------------------------------------------------------
_ELLIPSIS_POOL = "ZYXWVUTSRQPO"


def resolve_einsum_spec(espec: str, x_ndim: int) -> str:
    """Expand a ``...`` in the activation operand / output."""
    lhs, y = espec.replace(" ", "").split("->")
    xs, ws = lhs.split(",")
    if "..." in xs:
        fill = _ELLIPSIS_POOL[: x_ndim - (len(xs) - 3)]
        xs = xs.replace("...", fill)
        y = y.replace("...", fill)
    return f"{xs},{ws}->{y}"


@dataclasses.dataclass(frozen=True)
class EinsumPlan:
    """How to run ``einsum(spec, x, w)`` as ``[B, M, K] x [B, K, N]``."""

    spec: str
    x_perm: tuple
    w_perm: tuple
    y_perm: tuple
    n_batch: int
    n_x_free: int
    n_contract: int
    n_w_free: int


@functools.lru_cache(maxsize=256)
def plan_einsum(spec: str, x_ndim: int, w_ndim: int) -> EinsumPlan:
    """Parse a two-operand einsum into an :class:`EinsumPlan`."""
    lhs, y = resolve_einsum_spec(spec, x_ndim).split("->")
    xs, ws = lhs.split(",")
    if "..." in ws or "..." in y:
        raise ValueError(f"unsupported ellipsis placement in {spec!r}")
    if len(set(xs)) != len(xs) or len(set(ws)) != len(ws):
        raise ValueError(f"repeated labels unsupported: {spec!r}")
    if len(xs) != x_ndim or len(ws) != w_ndim:
        raise ValueError(f"{spec!r} does not match ranks ({x_ndim}, {w_ndim})")
    batch = [c for c in xs if c in ws and c in y]
    contract = [c for c in xs if c in ws and c not in y]
    x_free = [c for c in xs if c not in ws]
    w_free = [c for c in ws if c not in xs]
    if sorted(y) != sorted(batch + x_free + w_free):
        raise ValueError(f"output labels of {spec!r} not derivable")
    x_order = batch + x_free + contract
    w_order = batch + contract + w_free
    kernel_y = batch + x_free + w_free
    return EinsumPlan(
        spec=f"{xs},{ws}->{y}",
        x_perm=tuple(xs.index(c) for c in x_order),
        w_perm=tuple(ws.index(c) for c in w_order),
        y_perm=tuple(kernel_y.index(c) for c in y),
        n_batch=len(batch), n_x_free=len(x_free),
        n_contract=len(contract), n_w_free=len(w_free))


def _prod(dims) -> int:
    out = 1
    for d in dims:
        out *= int(d)
    return out


def _int8_fp_batched(x3, w3, x_zp, alpha):
    """uint8 ``[B, M, K]`` x int8 ``[B, K, N]`` -> ``(y, min, max)``."""
    zp = torch.as_tensor(x_zp, dtype=torch.float32).to(x3.device)
    al = torch.as_tensor(alpha, dtype=torch.float32).to(x3.device)
    if _on_cuda(x3, w3):
        return _mm.int8_matmul_fp_cuda(x3, w3, zp, al)
    return _mm.int8_matmul_fp_plain(x3, w3, zp, al)


def int8_matmul_fp(x_q: torch.Tensor, w_q: torch.Tensor, x_zp, alpha, *,
                   plan: EinsumPlan):
    """``alpha * einsum(plan.spec, x_q - zp_x, w_q)`` with the contraction
    exact in int32, plus the min/max of the fp32 result.  Returns ``(y in
    einsum output layout, obs_min, obs_max)``."""
    nb, nxf, nc = plan.n_batch, plan.n_x_free, plan.n_contract
    xt = x_q.permute(plan.x_perm)
    wt = w_q.permute(plan.w_perm)
    bdims = tuple(xt.shape[:nb])
    mdims = tuple(xt.shape[nb:nb + nxf])
    kdims = tuple(xt.shape[nb + nxf:])
    ndims = tuple(wt.shape[nb + nc:])
    b, m, k, n = _prod(bdims), _prod(mdims), _prod(kdims), _prod(ndims)
    y3, mn, mx = _int8_fp_batched(xt.reshape(b, m, k), wt.reshape(b, k, n),
                                  x_zp, alpha)
    y = y3.reshape(bdims + mdims + ndims).permute(plan.y_perm)
    return y, mn, mx


def int8_matmul_fused(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, x_zp,
                      w_scale, bias, out_qmin, out_qmax, *,
                      out_spec: QuantSpec = QuantSpec(bits=8,
                                                      symmetric=False)):
    """The paper's whole layer (Fig. 2/3) in one pass: uint8 ``x_q [M, K]``
    (asymmetric grid, zero point ``x_zp``) times int8 ``w_q [K, N]``, plus
    the int32 image ``round(bias / alpha)`` of an optional fp32 ``bias
    [N]``, dequantized once with ``alpha = x_scale * w_scale``, then
    requantized statically onto the grid of ``[out_qmin, out_qmax]``.
    Scalars are Python floats or 0-dim tensors.  Returns ``(q, obs_min,
    obs_max)``: ``q`` on ``out_spec``'s grid, min/max of the dequantized
    output."""
    dev = x_q.device
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                            device=dev)
    alpha = f32(x_scale) * f32(w_scale)
    zp = f32(x_zp)
    qp = _qparams(out_qmin, out_qmax, out_spec).to(dev)
    operands = (x_q, w_q) if bias is None else (x_q, w_q, bias)
    if _on_cuda(*operands):
        return _mm.int8_matmul_fused_cuda(x_q, w_q, zp, alpha, bias, qp,
                                          out_spec)
    return _mm.int8_matmul_fused_plain(x_q, w_q, zp, alpha, bias, qp,
                                       out_spec)


def int8_attention_fp(q_u8, k_i8, v_i8, regs, kvlen, *, sched: AttnSchedule):
    """Fused int8 attention core with in-kernel p-site stats.  Returns
    ``(out [BH, sq, hd], ml [BH, sq, 2], pstats [BH, nq, 6])``."""
    if _on_cuda(q_u8, k_i8, v_i8):
        return _attn.attention_cuda(q_u8, k_i8, v_i8, regs, kvlen,
                                    sched=sched)
    return _attn.attention_core_reference(q_u8, k_i8, v_i8, regs, kvlen,
                                          sched=sched)
