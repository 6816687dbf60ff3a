"""The int8 matmuls with their fused epilogues (port of
``repro/kernels/int8_matmul.py``).

Source note.  One CUDA source (``csrc/int8_matmul.cu``) holds one main
loop and two epilogues, replacing the two TPU kernels of the reference:

  * ``int8_matmul_fp`` replaces ``int8_matmul_fp_kernel`` (body
    ``_fp_kernel``): batched ``y = alpha * (sum_k (x - zp_x) * w)`` in
    fp32, plus (min, max) partials of ``y``;
  * ``int8_matmul_fused`` replaces ``int8_matmul_fused_kernel`` (body
    ``_kernel``), the paper's whole layer (Fig. 2/3): the same product
    plus the int32 image of a bias, one dequantizing rounding, the (min,
    max) statistics of ``y`` and a static requantization onto the next
    site's in-hindsight grid.  ``y`` never reaches device memory: the
    kernel writes 1 B per output element where the two-pass route
    (``int8_matmul_fp`` then ``fused_quantize``) writes 4, reads 4 and
    writes 1.

Activations are uint8 on the asymmetric grid, weights int8 symmetric; the
contraction is exact in int32.  On the H100 the LM prefill shapes are
bound by int8 operations; decode (M = 4) and the paper's CNN layers as
im2col products (small K and N) by bytes.  The kernel is a
shared-memory-tiled ``__dp4a`` GEMM (128 x 128 tiles, 8 x 8 per thread)
that stages the u8 activations onto the signed grid and restores the zero
point with an in-kernel weight column sum — int32-exact, far from the
tensor-core rate (wgmma/TMA are later work, in the shared main loop).

``torch.matmul`` has no int32 kernel on CUDA, so the plain versions
compute the integer contraction in float64 in the reference's form,
``(x - 128) . w + round(128 - zp_x) * colsum(w)``: every product and
partial sum is an integer far below 2**53, so it is exact in any order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QuantSpec

from . import LaunchCounter, build
from .fused_quantize import fused_quantize_plain

COUNTER = LaunchCounter("int8_matmul_fp")
FUSED_COUNTER = LaunchCounter("int8_matmul_fused")

BM = BN = 128                # the CUDA kernel's output tile
MAX_ROW_TILES = 65535        # gridDim.y


def _acc_plain(x3: torch.Tensor, w3: torch.Tensor, x_zp: torch.Tensor):
    """The exact int32 contraction, in float64: ``(x - 128) . w +
    round(128 - zp_x) * colsum(w)`` with the zero point's shift rounded in
    fp32, half to even, as the reference (and the kernel) rounds it."""
    shift = torch.round(128.0 - x_zp.to(torch.float32)).to(torch.float64)
    w64 = w3.to(torch.float64)
    return (torch.bmm(x3.to(torch.float64) - 128.0, w64)
            + shift * w64.sum(dim=1, keepdim=True))


def int8_matmul_fp_plain(x3: torch.Tensor, w3: torch.Tensor,
                         x_zp: torch.Tensor, alpha: torch.Tensor):
    """Plain version: ``(y fp32 [B, M, N], min, max)`` for uint8 ``x3
    [B, M, K]`` and int8 ``w3 [B, K, N]``."""
    y = alpha.to(torch.float32) * _acc_plain(x3, w3, x_zp).to(torch.float32)
    mn, mx = torch.aminmax(y)
    return y, mn, mx


def int8_matmul_fused_plain(x2: torch.Tensor, w2: torch.Tensor,
                            x_zp: torch.Tensor, alpha: torch.Tensor,
                            bias, qparams: torch.Tensor, spec: QuantSpec):
    """Plain version of the fused layer: ``(q [M, N], min, max)`` for uint8
    ``x2 [M, K]``, int8 ``w2 [K, N]``, an optional fp32 ``bias [N]`` and
    the out grid's registers ``qparams = [scale, zero_point]``.  ``q`` is
    uint8 on the asymmetric grid, int8 on the symmetric one; min/max are
    those of the dequantized ``y``."""
    # On the card, a tensor divided by a CPU scalar is multiplied by its
    # reciprocal: keep the divisors on x's device.
    alpha = alpha.to(device=x2.device, dtype=torch.float32)
    qparams = qparams.to(device=x2.device, dtype=torch.float32)
    acc = _acc_plain(x2[None], w2[None], x_zp)[0]
    if bias is not None:
        acc = acc + torch.round(bias.to(torch.float32) / alpha).to(
            torch.int32).to(torch.float64)
    y = alpha * acc.to(torch.float32)
    return fused_quantize_plain(y, qparams, spec)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {   # the C entry points of csrc/int8_matmul.cu
    "repro_int8_matmul_fp": [_VP] * 6 + [_CI] * 4 + [_VP],
    "repro_int8_matmul_fused": [_VP] * 8 + [_CI] * 5 + [_VP],
}


def _lib(name: str):
    fn = getattr(build.library("int8_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_operands(x, w, what: str, ndim: int):
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"{what} needs CUDA tensors")
    if x.dtype != torch.uint8 or w.dtype != torch.int8:
        raise TypeError(f"expected uint8 x int8, got {x.dtype} x {w.dtype}")
    if x.dim() != ndim or w.dim() != ndim or x.shape[:-2] != w.shape[:-2] \
            or x.shape[-1] != w.shape[-2]:
        raise ValueError(f"{what}: shape mismatch {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    if -(-x.shape[-2] // BM) > MAX_ROW_TILES:
        raise ValueError(f"{what}: M = {x.shape[-2]} exceeds "
                         f"{MAX_ROW_TILES} row tiles of {BM}")


def _scalar(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.to(device=like.device, dtype=torch.float32).reshape(1)


def int8_matmul_fp_cuda(x3: torch.Tensor, w3: torch.Tensor,
                        x_zp: torch.Tensor, alpha: torch.Tensor):
    """Launch the CUDA kernel; same returns as :func:`int8_matmul_fp_plain`."""
    _check_operands(x3, w3, "int8_matmul_fp_cuda", 3)
    b, m, k = x3.shape
    n = w3.shape[2]
    x3, w3 = x3.contiguous(), w3.contiguous()
    alpha, zp = _scalar(alpha, x3), _scalar(x_zp, x3)
    gm, gn = -(-m // BM), -(-n // BN)
    y = torch.empty((b, m, n), dtype=torch.float32, device=x3.device)
    partials = torch.empty((b, gm, gn, 2), dtype=torch.float32,
                           device=x3.device)
    status = _lib("repro_int8_matmul_fp")(
        x3.data_ptr(), w3.data_ptr(), y.data_ptr(), partials.data_ptr(),
        alpha.data_ptr(), zp.data_ptr(), b, m, k, n,
        torch.cuda.current_stream(x3.device).cuda_stream)
    build.check(status, "int8_matmul_fp")
    COUNTER.count += 1
    return y, partials[..., 0].amin(), partials[..., 1].amax()


def int8_matmul_fused_cuda(x2: torch.Tensor, w2: torch.Tensor,
                           x_zp: torch.Tensor, alpha: torch.Tensor,
                           bias, qparams: torch.Tensor, spec: QuantSpec):
    """Launch the CUDA kernel; same returns as
    :func:`int8_matmul_fused_plain`."""
    _check_operands(x2, w2, "int8_matmul_fused_cuda", 2)
    if spec.bits != 8:
        raise ValueError(f"the kernel stores 8-bit images, got {spec.bits}")
    m, k = x2.shape
    n = w2.shape[1]
    x2, w2 = x2.contiguous(), w2.contiguous()
    alpha, zp = _scalar(alpha, x2), _scalar(x_zp, x2)
    qparams = qparams.to(device=x2.device,
                         dtype=torch.float32).reshape(2).contiguous()
    if bias is not None:
        if not bias.is_cuda or bias.shape != (n,):
            raise ValueError(f"bias must be a CUDA tensor of shape ({n},)")
        bias = bias.to(torch.float32).contiguous()
    gm, gn = -(-m // BM), -(-n // BN)
    q = torch.empty((m, n), dtype=spec.storage_dtype, device=x2.device)
    partials = torch.empty((gm, gn, 2), dtype=torch.float32, device=x2.device)
    status = _lib("repro_int8_matmul_fused")(
        x2.data_ptr(), w2.data_ptr(), q.data_ptr(), partials.data_ptr(),
        alpha.data_ptr(), zp.data_ptr(),
        None if bias is None else bias.data_ptr(), qparams.data_ptr(),
        m, k, n, spec.int_min, spec.int_max,
        torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(status, "int8_matmul_fused")
    FUSED_COUNTER.count += 1
    return q, partials[..., 0].amin(), partials[..., 1].amax()
