"""Batched int8 matmul with an fp32 epilogue (port of the ``_fp_kernel``
variant of ``repro/kernels/int8_matmul.py``).

Source note.  The CUDA kernel (``csrc/int8_matmul.cu``) replaces the TPU
kernel ``int8_matmul_fp_kernel`` (``repro/kernels/int8_matmul.py``, body
``_fp_kernel``): ``y = alpha * (sum_k (x - zp_x) * w)`` for uint8
activations on the asymmetric grid and int8 symmetric weights, the
contraction exact in int32 and one fp32 rounding, plus (min, max)
partials of ``y``.  On the H100 the prefill shapes are bound by int8
operations and decode (M = 4) by bytes; this first kernel is a
shared-memory-tiled ``__dp4a`` GEMM (128 x 128 tiles, 8 x 8 per thread)
that stages the u8 activations onto the signed grid and restores the zero
point with an in-kernel weight column sum — int32-exact, far from the
tensor-core rate (wgmma/TMA are later work).

``torch.matmul`` has no int32 kernel on CUDA, so the plain version
computes the integer contraction in float64: every product and partial
sum is an integer far below 2**53, so it is exact in any order.
"""
from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, build

COUNTER = LaunchCounter("int8_matmul_fp")

BM = BN = 128                # the CUDA kernel's output tile


def int8_matmul_fp_plain(x3: torch.Tensor, w3: torch.Tensor,
                         x_zp: torch.Tensor, alpha: torch.Tensor):
    """Plain version: ``(y fp32 [B, M, N], min, max)`` for uint8 ``x3
    [B, M, K]`` and int8 ``w3 [B, K, N]``."""
    acc = torch.bmm(x3.to(torch.float64) - x_zp.to(torch.float64),
                    w3.to(torch.float64))
    y = alpha.to(torch.float32) * acc.to(torch.float32)
    mn, mx = torch.aminmax(y)
    return y, mn, mx


def _lib():
    lib = build.library("int8_matmul")
    fn = lib.repro_int8_matmul_fp
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul_fp_cuda(x3: torch.Tensor, w3: torch.Tensor,
                        x_zp: torch.Tensor, alpha: torch.Tensor):
    """Launch the CUDA kernel; same returns as :func:`int8_matmul_fp_plain`."""
    if not (x3.is_cuda and w3.is_cuda):
        raise ValueError("int8_matmul_fp_cuda needs CUDA tensors")
    if x3.dtype != torch.uint8 or w3.dtype != torch.int8:
        raise TypeError(f"expected uint8 x int8, got {x3.dtype} x {w3.dtype}")
    b, m, k = x3.shape
    b2, k2, n = w3.shape
    if (b, k) != (b2, k2):
        raise ValueError(
            f"shape mismatch {tuple(x3.shape)} x {tuple(w3.shape)}")
    x3, w3 = x3.contiguous(), w3.contiguous()
    alpha = alpha.to(device=x3.device, dtype=torch.float32).reshape(1)
    zp = x_zp.to(device=x3.device, dtype=torch.float32).reshape(1)
    gm, gn = -(-m // BM), -(-n // BN)
    y = torch.empty((b, m, n), dtype=torch.float32, device=x3.device)
    partials = torch.empty((b, gm, gn, 2), dtype=torch.float32,
                           device=x3.device)
    status = _lib()(x3.data_ptr(), w3.data_ptr(), y.data_ptr(),
                    partials.data_ptr(), alpha.data_ptr(), zp.data_ptr(),
                    b, m, k, n,
                    torch.cuda.current_stream(x3.device).cuda_stream)
    build.check(status, "int8_matmul_fp")
    COUNTER.count += 1
    return y, partials[..., 0].amin(), partials[..., 1].amax()
