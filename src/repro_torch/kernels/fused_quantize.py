"""Single-pass static quantization + online statistics (port of
``repro/kernels/fused_quantize.py``).

Source note.  The CUDA kernel (``csrc/fused_quantize.cu``) replaces the
TPU kernel ``fused_quantize_kernel`` (``repro/kernels/fused_quantize.py``,
body ``_kernel``).  With an in-hindsight range the quantizer is a pure
elementwise map, so one pass reads the fp32 tensor, writes its int8 image
and reduces the same values to (min, max) for the next step's range.  On
the H100 it is bound by bytes (4 B read + 1 B written per element); the
kernel streams with 16-byte loads and a bounded grid-stride loop, and
writes the core storage convention (uint8 asymmetric / int8 symmetric)
directly.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QuantSpec

from . import LaunchCounter, build

COUNTER = LaunchCounter("fused_quantize")

THREADS = 256
GRID_CAP = 132 * 16          # bounded grid: partials stay tiny


def fused_quantize_plain(x: torch.Tensor, qparams: torch.Tensor,
                         spec: QuantSpec):
    """Plain version: ``(q, min, max)`` of fp32 ``x`` quantized with the
    registers ``qparams = [scale, zero_point]``."""
    scale, zp = qparams[0], qparams[1]
    q = torch.round(x / scale + zp).clamp(float(spec.int_min),
                                          float(spec.int_max))
    mn, mx = torch.aminmax(x)
    return q.to(spec.storage_dtype), mn, mx


def _lib():
    lib = build.library("fused_quantize")
    fn = lib.repro_fused_quantize
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def fused_quantize_cuda(x: torch.Tensor, qparams: torch.Tensor,
                        spec: QuantSpec):
    """Launch the CUDA kernel; same returns as :func:`fused_quantize_plain`."""
    if not (x.is_cuda and qparams.is_cuda):
        raise ValueError("fused_quantize_cuda needs CUDA tensors")
    if x.dtype != torch.float32 or qparams.dtype != torch.float32:
        raise TypeError(f"fused_quantize_cuda takes float32, got {x.dtype}")
    if spec.bits != 8:
        raise ValueError(f"the kernel stores 8-bit images, got {spec.bits}")
    x = x.contiguous()
    qparams = qparams.reshape(2).contiguous()
    n = x.numel()
    items = max(1, -(-n // 4))
    grid = min(-(-items // THREADS), GRID_CAP)
    q = torch.empty(x.shape, dtype=spec.storage_dtype, device=x.device)
    partials = torch.empty((grid, 2), dtype=torch.float32, device=x.device)
    status = _lib()(x.data_ptr(), q.data_ptr(), partials.data_ptr(),
                    qparams.data_ptr(), n, int(spec.symmetric), grid,
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "fused_quantize")
    COUNTER.count += 1
    return q, partials[:, 0].amin(), partials[:, 1].amax()
