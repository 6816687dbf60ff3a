"""Quantized CNN building blocks (port of ``repro/cnn/layers.py``).

``qconv`` is the convolutional analogue of ``qlinear.qdense``: the same
W8/A8/G8 data path (shared activation quantizer on the input, current
min-max weights, gradient-quantization barrier on the output), so every
estimator study of the paper's Tables 1-3 runs unchanged on CNNs.

BatchNorm stays fp32 with fp32 running statistics — the paper (and all of
its baselines) keep BN in floating point.

Activations are NHWC and kernels HWIO, as in the reference: the im2col
lowering of ``kernels.ops.conv_patches`` and the parity tests depend on
that layout.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import backend, qlinear
from repro_torch.core.policy import QuantPolicy


def init_conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              groups: int = 1, dtype=torch.float32) -> torch.Tensor:
    """He-normal HWIO kernel drawn from ``gen`` (on ``gen``'s device)."""
    fan_in = kh * kw * cin // groups
    w = torch.randn((kh, kw, cin // groups, cout), generator=gen,
                    device=gen.device)
    return (w * (2.0 / fan_in) ** 0.5).to(dtype)


def qconv(x: torch.Tensor, w: torch.Tensor, site: dict, policy: QuantPolicy,
          *, seed, step, stride=1, padding="SAME", dilation=1,
          groups: int = 1, bias: Optional[torch.Tensor] = None):
    """Quantized conv (NHWC x HWIO -> NHWC).  Returns ``(y, stats_site)``.

    The activation quantizer returns the int8 image and its registers (on
    the fused backend its statistics are the quantize kernel's partials),
    and the contraction dispatches through
    :func:`repro_torch.core.backend.qconv`: integer-exact ``alpha * int32``
    on both backends when the policy is int8-eligible (depthwise and
    grouped convs lower onto the batched int8 matmul), the fp32 conv of
    the on-grid values otherwise.

    Gradient-site statistics are NOT in the returned stats dict (its
    ``"grad"`` slot is the "not visited" zeros vector): they arrive as the
    gradient of the site's ``"grad"`` leaf (``torch.autograd.grad`` over
    it), exactly as on the LM path (see ``qlinear.grad_quant_barrier``
    and ``merge_stats``).
    """
    xq, in_stats, xqt = qlinear.act_quant_site(x, site["act"], policy, step)
    wq, wqt = qlinear.quantize_weight_q(w, policy)
    if wq is not None:
        wq = wq.to(x.dtype)
    y = backend.qconv(policy, xq, xqt, wq, wqt, stride=stride,
                      padding=padding, dilation=dilation, groups=groups,
                      out_dtype=x.dtype)
    if bias is not None:
        y = y + bias
    y = qlinear.grad_quant_barrier(y, site["grad"], policy, seed, step)
    return y, {"act": in_stats, "grad": qlinear.stats_zeros(policy,
                                                            x.device)}


# ---------------------------------------------------------------------------
# Order-pinned fp reductions for the non-quantized CNN ops.
#
# BatchNorm and global average pooling are inexact fp reductions.
# ``tree_sum`` pins their association: a fixed pairwise halving tree of
# elementwise adds, padded with zeros to a power of two, so the value is
# the reference's bit for bit and the same on both backends.
#
# The reference also needs ``fence``/``runtime_one``: a runtime-opaque
# ``* 1.0`` that stops XLA from contracting a producer multiply into the
# next add as an FMA, which would depend on fusion decisions.  Eager
# PyTorch rounds every op apart and never contracts across ops, so the
# port has no counterpart: the BN tests show its values bit-equal to the
# reference's fenced ones.
# ---------------------------------------------------------------------------
def tree_sum(v: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sum over ``axis`` with a fixed pairwise association (bit-stable)."""
    v = torch.movedim(v, axis, 0)
    m = v.shape[0]
    p = 1 << max(m - 1, 0).bit_length()   # next power of two
    if p != m:                            # x + 0.0 is exact
        v = torch.cat([v, v.new_zeros((p - m,) + tuple(v.shape[1:]))])
    while p > 1:
        p //= 2
        v = v[:p] + v[p:]
    return v[0]


def tree_mean(v: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return tree_sum(v, axis) / v.shape[axis]


def init_bn(c: int, device=None) -> tuple:
    """``(params, state)``: scale 1 and bias 0; running mean 0, var 1."""
    params = {"scale": torch.ones((c,), dtype=torch.float32, device=device),
              "bias": torch.zeros((c,), dtype=torch.float32, device=device)}
    state = {"mean": torch.zeros((c,), dtype=torch.float32, device=device),
             "var": torch.ones((c,), dtype=torch.float32, device=device)}
    return params, state


def batchnorm(x: torch.Tensor, params, state: dict, *, train: bool,
              momentum: float = 0.9, eps: float = 1e-5):
    """fp32 BN.  Returns ``(y, new_state)``; the batch statistics use the
    order-pinned :func:`tree_mean` and are detached in the new state."""
    xf = x.to(torch.float32)
    if train:
        flat = xf.reshape(-1, xf.shape[-1])
        mean = tree_mean(flat)
        var = tree_mean((flat - mean) ** 2)
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * state["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (xf - mean) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return y.to(x.dtype), new_state


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    """Global average pool — an inexact fp reduction, order-pinned like
    BN."""
    n, h, w, c = x.shape
    return tree_mean(x.reshape(n, h * w, c), axis=1)


def maxpool(x: torch.Tensor, k: int = 2, s: int = 2) -> torch.Tensor:
    """``k x k`` max pool with stride ``s``, no padding (XLA's "VALID")."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)
