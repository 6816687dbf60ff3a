"""Single-pass stochastic-rounding quantization + online statistics, the
gradient quantizer's kernel (port of ``repro/kernels/stochastic_quantize.py``).

Source note.  The CUDA kernel (``csrc/stochastic_quantize.cu``) replaces
the TPU kernel ``stochastic_quantize_kernel``
(``repro/kernels/stochastic_quantize.py``, bodies ``_kernel`` and
``_kernel_onchip``).  With the range fixed in hindsight, stochastic
rounding ``floor(x / scale + zp + u)`` is elementwise, so one pass reads the
fp32 cotangent, writes its 8-bit image and reduces the same values to the
(min, max) that update the gradient site's range.  On the H100 it is bound
by bytes: 9 B per element with the noise ``u`` as an operand, 5 B when the
kernel draws ``u`` itself (Philox4x32-10 keyed by the Weyl-mixed site seed,
counter = element index; ``on_chip`` form).  The kernel streams with
16-byte loads and a bounded grid-stride loop, as ``fused_quantize`` does.

The operand form is bit-reproducible: both backends and the reference
replay it from the same noise.  The on-chip form has no plain counterpart
(its bits are the card's Philox stream) and is checked statistically; a CPU
tensor cannot take it, as the reference rejects it in interpret mode.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QuantSpec

from . import LaunchCounter, build

COUNTER = LaunchCounter("stochastic_quantize")

THREADS = 256
GRID_CAP = 132 * 16          # bounded grid: partials stay tiny


def stochastic_quantize_plain(x: torch.Tensor, qparams: torch.Tensor,
                              noise: torch.Tensor, spec: QuantSpec):
    """Plain version: ``(q, min, max)`` of fp32 ``x`` stochastically rounded
    with the noise ``u in [0, 1)`` and the registers ``qparams = [scale,
    zero_point]``."""
    scale, zp = qparams[0], qparams[1]
    q = torch.floor(x / scale + zp + noise).clamp(float(spec.int_min),
                                                  float(spec.int_max))
    mn, mx = torch.aminmax(x)
    return q.to(spec.storage_dtype), mn, mx


def _check(x: torch.Tensor, qparams: torch.Tensor, spec: QuantSpec) -> None:
    if not (x.is_cuda and qparams.is_cuda):
        raise ValueError("stochastic_quantize needs CUDA tensors")
    if x.dtype != torch.float32 or qparams.dtype != torch.float32:
        raise TypeError(f"stochastic_quantize takes float32, got {x.dtype}")
    if spec.bits != 8:
        raise ValueError(f"the kernel stores 8-bit images, got {spec.bits}")


def _launch_geometry(x: torch.Tensor, spec: QuantSpec):
    n = x.numel()
    grid = min(-(-max(1, -(-n // 4)) // THREADS), GRID_CAP)
    q = torch.empty(x.shape, dtype=spec.storage_dtype, device=x.device)
    partials = torch.empty((grid, 2), dtype=torch.float32, device=x.device)
    return n, grid, q, partials


def _fn(name: str, argtypes):
    fn = getattr(build.library("stochastic_quantize"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def stochastic_quantize_cuda(x: torch.Tensor, qparams: torch.Tensor,
                             noise: torch.Tensor, spec: QuantSpec):
    """Launch the operand form; same returns as
    :func:`stochastic_quantize_plain`."""
    _check(x, qparams, spec)
    if not noise.is_cuda or noise.dtype != torch.float32:
        raise TypeError("the noise operand must be a float32 CUDA tensor")
    if noise.shape != x.shape:
        raise ValueError(f"noise shape {tuple(noise.shape)} != x shape "
                         f"{tuple(x.shape)}")
    x, noise = x.contiguous(), noise.contiguous()
    qparams = qparams.reshape(2).contiguous()
    n, grid, q, partials = _launch_geometry(x, spec)
    vp = ctypes.c_void_p
    fn = _fn("repro_stochastic_quantize",
             [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_int, vp])
    status = fn(x.data_ptr(), noise.data_ptr(), q.data_ptr(),
                partials.data_ptr(), qparams.data_ptr(), n,
                int(spec.symmetric), grid,
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "stochastic_quantize")
    COUNTER.count += 1
    return q, partials[:, 0].amin(), partials[:, 1].amax()


def stochastic_quantize_onchip_cuda(x: torch.Tensor, qparams: torch.Tensor,
                                    seed: int, spec: QuantSpec):
    """Launch the on-chip form: the noise comes from the kernel's Philox
    stream keyed by ``seed`` (taken mod 2**32)."""
    _check(x, qparams, spec)
    x = x.contiguous()
    qparams = qparams.reshape(2).contiguous()
    n, grid, q, partials = _launch_geometry(x, spec)
    vp = ctypes.c_void_p
    fn = _fn("repro_stochastic_quantize_onchip",
             [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_uint32, ctypes.c_int, vp])
    status = fn(x.data_ptr(), q.data_ptr(), partials.data_ptr(),
                qparams.data_ptr(), n, int(spec.symmetric),
                int(seed) & 0xFFFFFFFF, grid,
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "stochastic_quantize (on-chip)")
    COUNTER.count += 1
    return q, partials[:, 0].amin(), partials[:, 1].amax()
