"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``).

Shape plumbing (arbitrary-rank einsum -> batched 3-D matmul and back),
the pre-computed quant registers, and dispatch on where the operands lie:

  * CPU tensors   -> the kernel's plain PyTorch version,
  * CUDA tensors  -> the hand-written CUDA kernel (launched, or raises),
  * anything else -> raises.

There is no fallback between the two: a CUDA tensor never runs the plain
version here.  An empty operand (a model rank's empty share of a padded
head dim) launches nothing on either: the wrappers return empty (or, for
an empty contraction, zero) outputs and neutral ``(+inf, -inf)``
statistics.  All wrappers return core-convention integers (uint8
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
from . import tuning
from .int8_attention import AttnSchedule

COUNTERS = (_fq.COUNTER, _mm.COUNTER, _attn.COUNTER, _sq.COUNTER,
            _mm.FUSED_COUNTER, _mm.TRANSPOSE_COUNTER, _mm.INT32_COUNTER,
            _mm.EPILOGUE_COUNTER)


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last reset."""
    return {c.name: c.count for c in COUNTERS}


def tile_launch_counts() -> dict:
    """``{(kernel name, row tile): launches}`` of the int8 matmuls since
    the last reset."""
    out = {("int8_matmul_fp", bm): c.count
           for bm, c in _mm.TILE_COUNTERS.items()}
    out.update({("int8_matmul_fused", bm): c.count
                for bm, c in _mm.FUSED_TILE_COUNTERS.items()})
    out[("int8_attention", "general")] = _attn.GENERAL_COUNTER.count
    return out


def reset_launch_counts() -> None:
    for c in (*COUNTERS, *_mm.TILE_COUNTERS.values(),
              *_mm.FUSED_TILE_COUNTERS.values(), _attn.GENERAL_COUNTER):
        c.count = 0


def _dtype_name(t: torch.Tensor) -> str:
    """``"uint8"`` for ``torch.uint8``: the reference's dtype string in
    the tile cache's key."""
    return str(t.dtype).removeprefix("torch.")


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


def _empty_quantize(x: torch.Tensor, spec: QuantSpec):
    """``(q, min, max)`` of an empty tensor: nothing launched."""
    inf = torch.tensor(float("inf"), device=x.device)
    return torch.empty(x.shape, dtype=spec.storage_dtype,
                       device=x.device), inf, -inf


def fused_quantize(x: torch.Tensor, qmin, qmax, *,
                   spec: QuantSpec = QuantSpec(bits=8, symmetric=False)):
    """Single-pass static quantize + stats: ``(q, obs_min, obs_max)``."""
    qp = _qparams(qmin, qmax, spec).to(x.device)
    xf = x.to(torch.float32)
    if xf.numel() == 0:
        return _empty_quantize(xf, spec)
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
    return stochastic_quantize_registers(xf, qp, noise, spec=spec)


def stochastic_quantize_registers(x: torch.Tensor, qparams: torch.Tensor,
                                  noise: torch.Tensor, *, spec: QuantSpec):
    """:func:`stochastic_quantize`'s operand form with the registers
    ``qparams = [scale, zero_point]`` given (the int8 gradient collective
    derives its own scale): ``floor(x / scale + zero_point + u)``,
    clipped, and the (min, max) of ``x``."""
    xf, qp = x.to(torch.float32), qparams.to(x.device, torch.float32)
    nf = noise.to(torch.float32)
    if xf.numel() == 0:
        return _empty_quantize(xf, spec)
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


def _int8_fp_batched(x3, w3, x_zp, alpha, block):
    """uint8 ``[B, M, K]`` x int8 ``[B, K, N]`` -> ``(y, min, max)``; the
    kernel runs on the tile ``block``."""
    zp = torch.as_tensor(x_zp, dtype=torch.float32).to(x3.device)
    al = torch.as_tensor(alpha, dtype=torch.float32).to(x3.device)
    b, m, n = x3.shape[0], x3.shape[1], w3.shape[2]
    if b * m * n == 0:
        inf = torch.tensor(float("inf"), device=x3.device)
        return x3.new_zeros((b, m, n), dtype=torch.float32), inf, -inf
    if x3.shape[2] == 0:    # an empty contraction: alpha * 0
        y = al * x3.new_zeros((b, m, n), dtype=torch.float32)
        zero = y.new_zeros(())
        return y, zero, zero
    if _on_cuda(x3, w3):
        return _mm.int8_matmul_fp_cuda(x3, w3, zp, al, block=block)
    return _mm.int8_matmul_fp_plain(x3, w3, zp, al)


def int8_matmul_fp(x_q: torch.Tensor, w_q: torch.Tensor, x_zp, alpha, *,
                   plan: EinsumPlan, block=None):
    """``alpha * einsum(plan.spec, x_q - zp_x, w_q)`` with the contraction
    exact in int32, plus the min/max of the fp32 result.  Returns ``(y in
    einsum output layout, obs_min, obs_max)``.  ``block=None`` resolves
    the tile through :func:`tuning.matmul_block` (``REPRO_MM_BLOCK`` /
    ``REPRO_TUNE`` aware), as the reference does."""
    nb, nxf, nc = plan.n_batch, plan.n_x_free, plan.n_contract
    xt = x_q.permute(plan.x_perm)
    wt = w_q.permute(plan.w_perm)
    bdims = tuple(xt.shape[:nb])
    mdims = tuple(xt.shape[nb:nb + nxf])
    kdims = tuple(xt.shape[nb + nxf:])
    ndims = tuple(wt.shape[nb + nc:])
    b, m, k, n = _prod(bdims), _prod(mdims), _prod(kdims), _prod(ndims)
    if block is None and b * m * k * n:
        block = tuning.matmul_block(m, n, k, dtype=_dtype_name(x_q))
    y3, mn, mx = _int8_fp_batched(xt.reshape(b, m, k), wt.reshape(b, k, n),
                                  x_zp, alpha, block)
    y = y3.reshape(bdims + mdims + ndims).permute(plan.y_perm)
    return y, mn, mx


def int8_matmul_int32(x_q: torch.Tensor, w_q: torch.Tensor, x_zp, *,
                      plan: EinsumPlan, block=None) -> torch.Tensor:
    """The int32 mode of :func:`int8_matmul_fp`: ``einsum(plan.spec, x_q -
    zp_x, w_q)`` exact in int32 (``acc + corr``), in einsum output layout,
    with no epilogue and no statistics: a K shard's partial, which
    :func:`int8_matmul_epilogue` finishes once the shards are summed."""
    nb, nxf, nc = plan.n_batch, plan.n_x_free, plan.n_contract
    xt = x_q.permute(plan.x_perm)
    wt = w_q.permute(plan.w_perm)
    bdims = tuple(xt.shape[:nb])
    mdims = tuple(xt.shape[nb:nb + nxf])
    ndims = tuple(wt.shape[nb + nc:])
    b, m, n = _prod(bdims), _prod(mdims), _prod(ndims)
    k = _prod(xt.shape[nb + nxf:])
    x3, w3 = xt.reshape(b, m, k), wt.reshape(b, k, n)
    zp = torch.as_tensor(x_zp, dtype=torch.float32).to(x3.device)
    if b * m * n * k == 0:  # a rank's empty K share: a zero partial
        acc = x3.new_zeros((b, m, n), dtype=torch.int32)
    elif _on_cuda(x3, w3):
        if block is None:
            block = tuning.matmul_block(m, n, k, dtype=_dtype_name(x_q))
        acc = _mm.int8_matmul_int32_cuda(x3, w3, zp, block=block)
    else:
        acc = _mm.int8_matmul_int32_plain(x3, w3, zp)
    return acc.reshape(bdims + mdims + ndims).permute(plan.y_perm)


def int8_matmul_epilogue(acc: torch.Tensor, alpha):
    """``(alpha * float(acc), min, max)`` of summed int32 partials: the
    fused epilogue of :func:`int8_matmul_fp`, op for op."""
    al = torch.as_tensor(alpha, dtype=torch.float32).to(acc.device)
    if _on_cuda(acc):
        return _mm.int8_matmul_epilogue_cuda(acc, al)
    return _mm.int8_matmul_epilogue_plain(acc, al)


def int8_matmul_fused(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, x_zp,
                      w_scale, bias, out_qmin, out_qmax, *,
                      out_spec: QuantSpec = QuantSpec(bits=8,
                                                      symmetric=False),
                      block=None):
    """The paper's whole layer (Fig. 2/3) in one pass: uint8 ``x_q [M, K]``
    (asymmetric grid, zero point ``x_zp``) times int8 ``w_q [K, N]``, plus
    the int32 image ``round(bias / alpha)`` of an optional fp32 ``bias
    [N]``, dequantized once with ``alpha = x_scale * w_scale``, then
    requantized statically onto the grid of ``[out_qmin, out_qmax]``.
    Scalars are Python floats or 0-dim tensors.  Returns ``(q, obs_min,
    obs_max)``: ``q`` on ``out_spec``'s grid, min/max of the dequantized
    output.  ``block=None`` resolves the tile as :func:`int8_matmul_fp`
    does."""
    dev = x_q.device
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                            device=dev)
    alpha = f32(x_scale) * f32(w_scale)
    zp = f32(x_zp)
    qp = _qparams(out_qmin, out_qmax, out_spec).to(dev)
    operands = (x_q, w_q) if bias is None else (x_q, w_q, bias)
    if block is None:
        block = tuning.matmul_block(x_q.shape[0], w_q.shape[1],
                                    x_q.shape[1], dtype=_dtype_name(x_q))
    if _on_cuda(*operands):
        return _mm.int8_matmul_fused_cuda(x_q, w_q, zp, alpha, bias, qp,
                                          out_spec, block=block)
    return _mm.int8_matmul_fused_plain(x_q, w_q, zp, alpha, bias, qp,
                                       out_spec)


def int8_attention_fp(q_u8, k_i8, v_i8, regs, kvlen, *, sched: AttnSchedule,
                      q_start: int = 0):
    """Fused int8 attention core with in-kernel p-site stats.  Returns
    ``(out [BH, sq, hd], ml [BH, sq, 2], pstats [BH, nq, 6])``; ``q_u8``
    holds the rows ``[q_start, q_start + sq)`` of ``sched``'s call."""
    kw = {"q_start": q_start} if q_start else {}
    if q_u8.shape[0] == 0:
        return _attn.empty_core(q_u8, sched, q_start)
    if _on_cuda(q_u8, k_i8, v_i8):
        return _attn.attention_cuda(q_u8, k_i8, v_i8, regs, kvlen,
                                    sched=sched, **kw)
    return _attn.attention_core_reference(q_u8, k_i8, v_i8, regs, kvlen,
                                          sched=sched, **kw)


# ---------------------------------------------------------------------------
# Convolution plumbing: lower an NHWC x HWIO conv onto the batched 3-D
# [B, M, K] x [B, K, N] matmul kernel (B carries the groups; depthwise is
# the G == C_in, K == KH*KW, N == multiplier corner of the same form).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How to run an NHWC x HWIO conv on the 3-D matmul kernel.

    The conv analogue of :class:`EinsumPlan`: a hashable record of the
    geometry — batch/spatial/channel extents, stride, kernel dilation,
    resolved padding pairs and group split — plus the derived output
    extents.  :func:`conv_patches` uses it to im2col the activation image
    into ``[G, N*OH*OW, KH*KW*Cg]`` and :func:`conv_lower_weights` to fold
    the HWIO kernel into ``[G, KH*KW*Cg, Fg]``; the contraction is then
    exactly the batched matmul the int8 kernel executes.
    """

    n: int                   # batch
    h: int                   # input height
    w: int                   # input width
    cin: int                 # input channels (total, all groups)
    kh: int                  # kernel height
    kw: int                  # kernel width
    cout: int                # output channels (total, all groups)
    groups: int              # feature_group_count
    stride: tuple            # (sh, sw)
    dilation: tuple          # (dh, dw) — kernel (rhs/atrous) dilation
    pads: tuple              # ((ph0, ph1), (pw0, pw1)) resolved padding
    oh: int                  # output height
    ow: int                  # output width

    @property
    def cin_g(self) -> int:
        return self.cin // self.groups

    @property
    def cout_g(self) -> int:
        return self.cout // self.groups

    @property
    def m(self) -> int:
        return self.n * self.oh * self.ow

    @property
    def k(self) -> int:
        return self.kh * self.kw * self.cin_g


def _pair(v) -> tuple:
    return tuple(int(a) for a in v) if isinstance(v, (tuple, list)) \
        else (int(v), int(v))


def _padtype_to_pads(in_hw, window, strides, padding: str) -> tuple:
    """XLA's ``padtype_to_pads``: ``"SAME"`` pads the dilated window to
    ``ceil(in / stride)`` outputs, ``total // 2`` before and the rest
    after; ``"VALID"`` pads nothing."""
    if padding == "VALID":
        return tuple((0, 0) for _ in in_hw)
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}; expected 'SAME', "
                         f"'VALID' or explicit ((lo, hi), (lo, hi))")
    pads = []
    for size, win, s in zip(in_hw, window, strides):
        out = -(-size // s)
        total = max((out - 1) * s + win - size, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


@functools.lru_cache(maxsize=256)
def _plan_conv_cached(x_shape, w_shape, stride, padding, dilation,
                      groups) -> ConvPlan:
    n, h, w, cin = x_shape
    kh, kw, cin_g, cout = w_shape
    if cin_g * groups != cin or cout % groups:
        raise ValueError(
            f"conv geometry mismatch: x channels {cin}, kernel input "
            f"channels {cin_g} x groups {groups}, out channels {cout}")
    sh, sw = stride
    dh, dw = dilation
    eff = ((kh - 1) * dh + 1, (kw - 1) * dw + 1)   # dilated kernel extent
    pads = _padtype_to_pads((h, w), eff, (sh, sw), padding) \
        if isinstance(padding, str) else padding
    oh = (h + pads[0][0] + pads[0][1] - eff[0]) // sh + 1
    ow = (w + pads[1][0] + pads[1][1] - eff[1]) // sw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty conv output ({oh}, {ow}) for input "
                         f"{x_shape} kernel {w_shape} pads {pads}")
    return ConvPlan(n=n, h=h, w=w, cin=cin, kh=kh, kw=kw, cout=cout,
                    groups=groups, stride=(sh, sw), dilation=(dh, dw),
                    pads=pads, oh=oh, ow=ow)


def plan_conv(x_shape, w_shape, stride=1, padding="SAME", dilation=1,
              groups: int = 1) -> ConvPlan:
    """Resolve an NHWC x HWIO conv into a :class:`ConvPlan`.

    ``padding`` is ``"SAME"`` / ``"VALID"`` (resolved with XLA's rules on
    the dilated kernel extent, so the lowered conv matches the reference's
    ``lax.conv_general_dilated`` exactly) or an explicit ``((ph0, ph1),
    (pw0, pw1))``.
    """
    return _plan_conv_cached(tuple(map(int, x_shape)),
                             tuple(map(int, w_shape)),
                             _pair(stride), padding if isinstance(padding, str)
                             else tuple((int(a), int(b)) for a, b in padding),
                             _pair(dilation), int(groups))


def _tap(t: torch.Tensor, plan: ConvPlan, i: int, j: int):
    """The strided window of kernel tap ``(i, j)`` in a padded NHWC image:
    ``[N, OH, OW, C]``, a view."""
    (sh, sw), (dh, dw) = plan.stride, plan.dilation
    r0, c0 = i * dh, j * dw
    return t[:, r0:r0 + (plan.oh - 1) * sh + 1:sh,
             c0:c0 + (plan.ow - 1) * sw + 1:sw, :]


def conv_patches(x: torch.Tensor, plan: ConvPlan, pad_value) -> torch.Tensor:
    """im2col: NHWC image -> ``[G, N*OH*OW, KH*KW*Cg]`` patch matrix.

    Dtype-generic (runs on the uint8 integer image as well as fp), which
    is what lets the int8 conv pad in *integer* space: padding with the
    activation zero point makes every padded tap contribute exactly
    ``(zp - zp) * w == 0`` after the kernel's zero-point correction —
    bit-identical to fp zero padding.  K is laid out ``(kh, kw, cg)`` to
    match :func:`conv_lower_weights`.  ``pad_value`` is a number or a
    0-dim tensor on ``x``'s device (read there, with no host sync).
    """
    (ph0, ph1), (pw0, pw1) = plan.pads
    shape = (plan.n, plan.h + ph0 + ph1, plan.w + pw0 + pw1, plan.cin)
    if (ph0, ph1, pw0, pw1) == (0, 0, 0, 0):
        xp = x
    else:
        if isinstance(pad_value, torch.Tensor):
            xp = pad_value.to(x.dtype).expand(shape).clone()
        else:
            xp = torch.full(shape, pad_value, dtype=x.dtype, device=x.device)
        xp[:, ph0:ph0 + plan.h, pw0:pw0 + plan.w, :] = x
    p = torch.stack([_tap(xp, plan, i, j) for i in range(plan.kh)
                     for j in range(plan.kw)], dim=3)  # [N,OH,OW,KHKW,C]
    p = p.reshape(plan.n, plan.oh, plan.ow, plan.kh * plan.kw,
                  plan.groups, plan.cin_g)
    p = p.permute(4, 0, 1, 2, 3, 5)                  # [G,N,OH,OW,KHKW,Cg]
    return p.reshape(plan.groups, plan.m, plan.k)


def conv_lower_weights(w: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """HWIO kernel -> ``[G, KH*KW*Cg, Fg]`` (XLA group convention: output
    feature ``f`` belongs to group ``f // Fg``)."""
    wk = w.reshape(plan.kh * plan.kw * plan.cin_g, plan.groups, plan.cout_g)
    return wk.permute(1, 0, 2)


def conv_unlower_output(y3: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Kernel output ``[G, N*OH*OW, Fg]`` -> NHWC ``[N, OH, OW, G*Fg]``."""
    y = y3.reshape(plan.groups, plan.n, plan.oh, plan.ow, plan.cout_g)
    return y.permute(1, 2, 3, 0, 4).reshape(plan.n, plan.oh, plan.ow,
                                            plan.cout)


def conv_lower_output(y: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """NHWC ``[N, OH, OW, F]`` -> ``[G, N*OH*OW, Fg]`` (inverse of
    :func:`conv_unlower_output`; used for output cotangents)."""
    y = y.reshape(plan.n, plan.oh, plan.ow, plan.groups, plan.cout_g)
    return y.permute(3, 0, 1, 2, 4).reshape(plan.groups, plan.m,
                                            plan.cout_g)


def conv_unlower_weights(wl: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """``[G, KH*KW*Cg, Fg]`` -> HWIO (inverse of
    :func:`conv_lower_weights`; used for weight cotangents)."""
    return wl.permute(1, 0, 2).reshape(plan.kh, plan.kw, plan.cin_g,
                                       plan.cout)


def conv_unpatch(dp: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """col2im: the linear transpose of :func:`conv_patches` (zero pad).

    Adds each kernel tap's cotangent slab onto a zero padded image with a
    strided in-place add, taps in the reference's fixed loop order, and
    crops the padding.  Within a tap the strided elements are disjoint,
    so every element's fp32 sum is accumulated in the same order as the
    reference's — bit-identical to it, on either device.
    """
    (ph0, ph1), (pw0, pw1) = plan.pads
    dp = dp.reshape(plan.groups, plan.n, plan.oh, plan.ow,
                    plan.kh * plan.kw, plan.cin_g)
    dp = dp.permute(1, 2, 3, 4, 0, 5).reshape(
        plan.n, plan.oh, plan.ow, plan.kh * plan.kw, plan.cin)
    xp = dp.new_zeros((plan.n, plan.h + ph0 + ph1, plan.w + pw0 + pw1,
                       plan.cin))
    for i in range(plan.kh):
        for j in range(plan.kw):
            _tap(xp, plan, i, j).add_(dp[..., i * plan.kw + j, :])
    return xp[:, ph0:ph0 + plan.h, pw0:pw0 + plan.w, :]


def int8_conv_fp(x_q: torch.Tensor, w_q: torch.Tensor, x_zp, alpha, *,
                 plan: ConvPlan, block=None):
    """Quantized conv on the int8 matmul path with an fp32 result.

    im2col-lowers the uint8 NHWC image (padding with ``round(x_zp)``, see
    :func:`conv_patches`) and the int8 HWIO kernel onto the batched
    ``[G, M, K] x [G, K, Fg]`` layout of the int8 matmul: a CUDA tensor
    gets ``int8_matmul_fp``'s kernel, a CPU tensor its plain version.
    Contraction exact in int32, one fp32 multiply epilogue — the
    arithmetic contract of :func:`int8_matmul_fp`.  Returns ``(y fp32
    NHWC, obs_min, obs_max)``: the statistics are the min/max of ``y``,
    and ``y`` is contiguous (for grouped convs the unlowering is a
    strided view until copied), so what reduces over it later sums in one
    order whichever backend made it.  The lowered conv shares the matmul's
    tiles: ``block=None`` resolves through :func:`tuning.matmul_block` at
    ``(M, Fg, K)``.
    """
    if block is None:
        block = tuning.matmul_block(plan.m, plan.cout_g, plan.k,
                                    dtype=_dtype_name(x_q))
    pad_q = torch.round(torch.as_tensor(x_zp, dtype=torch.float32,
                                        device=x_q.device))
    patches = conv_patches(x_q, plan, pad_q)        # fp 0.0 == integer zp
    ws = conv_lower_weights(w_q, plan)
    y3, mn, mx = _int8_fp_batched(patches, ws, x_zp, alpha, block)
    return conv_unlower_output(y3, plan).contiguous(), mn, mx
