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
im2col products (small K and N) by bytes.  The main loop runs on the
tensor cores: warp-level ``mma.sync`` u8 x s8 -> s32 (the u8 activations
go in as they are, and the zero point comes back as the column
correction ``(round(128 - zp_x) - 128) * colsum(w)``), BM x 128 tiles of
8 warps, K in 128-byte slabs through a 3-stage ``cp.async`` ring in
swizzled shared memory, fragments loaded with ``ldmatrix``.  The row tile
BM is 128, 64, 32 or 16 (:data:`ROW_TILES`): the caller's tile comes from
``tuning.matmul_block``, and :func:`row_tile` clamps it to the least
instantiated row tile that covers M, so decode's M = 4 computes 16 rows
and not 128.  ``mma``
reads the weight K-contiguous, so the wrapper stages the operands first
(:func:`stage_operands`): another kernel of the same source,
``int8_transpose``, writes the weight's K-major image ``[B, N, K]``,
and K is zero-padded to a multiple of 16.  What bounds the kernel now is
the ``mma.sync`` instruction rate and the shared-memory traffic of its
fragment loads: warp-level MMA reaches only part of Hopper's int8
tensor-core rate, which takes ``wgmma`` with operands read from shared
memory by the tensor cores.  ``mma.sync`` came first because its
register-level fragments keep the old epilogues as they were and are
checked element by element; ``wgmma`` + TMA with a persistent,
warp-specialised schedule is the next step in the same shared main loop,
and a weight site that writes the K-major image directly removes the
transpose.

The same source's int32 mode (:func:`int8_matmul_int32_cuda`) and its
epilogue (:func:`int8_matmul_epilogue_cuda`) replace no TPU kernel: they
split ``int8_matmul_fp`` around a reduction, for a product whose K is
sharded over a model axis (Megatron's row-parallel half).  The int32
mode runs the same main loop and writes ``acc + corr``, ``corr`` from the
rank's own K rows; the ranks' int32 partials sum exactly; the epilogue
then takes ``alpha * float(.)`` and the (min, max) partials, the fused
epilogue's one rounding, so the result is the unsharded kernel's bit for
bit.  No statistic is taken of the int32 partials.

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
from .tuning import MATMUL_DEFAULT, MATMUL_TILES

COUNTER = LaunchCounter("int8_matmul_fp")
FUSED_COUNTER = LaunchCounter("int8_matmul_fused")
TRANSPOSE_COUNTER = LaunchCounter("int8_transpose")
INT32_COUNTER = LaunchCounter("int8_matmul_int32")
EPILOGUE_COUNTER = LaunchCounter("int8_matmul_epilogue")

ROW_TILES = tuple(t[0] for t in MATMUL_TILES)   # the kernel's row tiles
# Launches of each row tile, counted beside COUNTER / FUSED_COUNTER.
TILE_COUNTERS = {bm: LaunchCounter(f"int8_matmul_fp bm={bm}")
                 for bm in ROW_TILES}
FUSED_TILE_COUNTERS = {bm: LaunchCounter(f"int8_matmul_fused bm={bm}")
                       for bm in ROW_TILES}
MAX_ROW_TILES = 65535        # gridDim.y
K_ALIGN = 16                 # K padding and operand alignment, bytes


def check_tile(block) -> tuple:
    """``block`` as a tuple, if the CUDA kernel instantiates it."""
    block = tuple(int(b) for b in block)
    if block not in MATMUL_TILES:
        raise ValueError(f"the CUDA int8 matmul has no tile {block}; its "
                         f"tiles are {MATMUL_TILES}")
    return block


def row_tile(bm: int, m: int) -> int:
    """The row tile a launch runs for the tile row ``bm`` at ``m`` rows:
    ``bm``, or where M is below it the least instantiated row tile that
    covers M (the counterpart of the Pallas block's ``min(bm, M)``)."""
    if m >= bm:
        return bm
    return min(t for t in ROW_TILES if t >= m)


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


def int8_matmul_int32_plain(x3: torch.Tensor, w3: torch.Tensor,
                            x_zp: torch.Tensor) -> torch.Tensor:
    """Plain version of the int32 mode: ``acc + corr`` int32 ``[B, M,
    N]`` of uint8 ``x3 [B, M, K]`` and int8 ``w3 [B, K, N]`` (exact in
    float64, then cast)."""
    return _acc_plain(x3, w3, x_zp).to(torch.int32)


def int8_matmul_epilogue_plain(acc: torch.Tensor, alpha: torch.Tensor):
    """Plain version of the int32 mode's epilogue: ``(y = alpha *
    float(acc), min, max)``, the fused epilogue's one rounding."""
    y = alpha.to(device=acc.device, dtype=torch.float32) * acc.to(
        torch.float32)
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
    "repro_int8_matmul_fp": [_VP] * 6 + [_CI] * 5 + [_VP],
    "repro_int8_matmul_fused": [_VP] * 8 + [_CI] * 6 + [_VP],
    "repro_int8_transpose": [_VP] * 2 + [_CI] * 3 + [_VP],
    "repro_int8_matmul_int32": [_VP] * 4 + [_CI] * 5 + [_VP],
    "repro_int8_matmul_epilogue": [_VP] * 4 + [ctypes.c_longlong, _VP],
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


def _scalar(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.to(device=like.device, dtype=torch.float32).reshape(1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, starting on a 16-byte boundary (cp.async copies
    whole 16-byte chunks)."""
    t = t.contiguous()
    return t if t.data_ptr() % K_ALIGN == 0 else t.clone()


def _pad_k(t: torch.Tensor) -> torch.Tensor:
    """``t [..., K]`` with K zero-padded to a multiple of 16."""
    k = t.shape[-1]
    kp = -(-k // K_ALIGN) * K_ALIGN
    if kp == k:
        return t
    out = t.new_zeros(t.shape[:-1] + (kp,))
    out[..., :k] = t
    return out


def weight_kmajor_plain(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the transpose kernel: int8 ``w [..., K, N]`` ->
    its K-major image ``[..., N, Kp]``, K zero-padded to a multiple of
    16."""
    return _pad_k(w.transpose(-1, -2)).contiguous()


def weight_kmajor_cuda(w: torch.Tensor) -> torch.Tensor:
    """Launch the transpose kernel; same return as
    :func:`weight_kmajor_plain`."""
    if not w.is_cuda or w.dtype != torch.int8:
        raise ValueError(f"weight_kmajor_cuda needs a CUDA int8 tensor, got "
                         f"{w.dtype} on {w.device}")
    w = _aligned(w)
    *batch, k, n = w.shape
    b = w.numel() // max(k * n, 1)
    wt = torch.empty((*batch, n, -(-k // K_ALIGN) * K_ALIGN),
                     dtype=torch.int8, device=w.device)
    status = _lib("repro_int8_transpose")(
        w.data_ptr(), wt.data_ptr(), b, k, n,
        torch.cuda.current_stream(w.device).cuda_stream)
    build.check(status, "int8_transpose")
    TRANSPOSE_COUNTER.count += 1
    return wt


def stage_operands(x: torch.Tensor, w: torch.Tensor):
    """The kernels' operand layout: uint8 ``x [..., M, K]`` and int8 ``w
    [..., K, N]`` become ``x [..., M, Kp]`` and the K-major weight ``[...,
    N, Kp]`` (mma's B operand is K-contiguous), contiguous and 16-byte
    aligned, K zero-padded in both to ``Kp``, a multiple of 16.  The padded
    bytes meet zero weights, so they add nothing to the product and leave
    the weight column sums as they were.  The weight's transpose is a
    kernel on the card, its plain version on the CPU."""
    wk = weight_kmajor_cuda(w) if w.is_cuda else weight_kmajor_plain(w)
    return _aligned(_pad_k(x)), wk


def _check_staged(x, wk, what: str):
    if x.shape[-1] % K_ALIGN or x.shape[-1] != wk.shape[-1] \
            or not (x.is_contiguous() and wk.is_contiguous()) \
            or x.data_ptr() % K_ALIGN or wk.data_ptr() % K_ALIGN:
        raise ValueError(f"{what}: operands are not staged (see "
                         f"stage_operands): {tuple(x.shape)} x "
                         f"{tuple(wk.shape)}")


def int8_matmul_fp_cuda(x3: torch.Tensor, w3: torch.Tensor,
                        x_zp: torch.Tensor, alpha: torch.Tensor,
                        block=MATMUL_DEFAULT):
    """Launch the CUDA kernel on the tile ``block`` (one of
    ``tuning.MATMUL_TILES``, its rows clamped by :func:`row_tile`); same
    returns as :func:`int8_matmul_fp_plain`."""
    _check_operands(x3, w3, "int8_matmul_fp_cuda", 3)
    return int8_matmul_fp_cuda_staged(*stage_operands(x3, w3), x_zp, alpha,
                                      block=block)


def int8_matmul_fp_cuda_staged(xk: torch.Tensor, wk: torch.Tensor,
                               x_zp: torch.Tensor, alpha: torch.Tensor,
                               block=MATMUL_DEFAULT, clamp: bool = True):
    """The kernel on operands already staged by :func:`stage_operands`:
    uint8 ``xk [B, M, Kp]``, int8 K-major ``wk [B, N, Kp]``.  Past
    ``MAX_ROW_TILES`` row tiles (the grid's y limit) M is split into
    chunks of at most that many tiles, one launch each, in the kernel's
    own tile order.  ``clamp=False`` runs ``block``'s row tile even where
    M is below it (the tile as it is, for measurements)."""
    _check_operands(xk, wk.transpose(-1, -2), "int8_matmul_fp_cuda", 3)
    _check_staged(xk, wk, "int8_matmul_fp_cuda")
    block = check_tile(block)
    b, m, k = xk.shape
    bm = row_tile(block[0], m) if clamp else block[0]
    rows = MAX_ROW_TILES * bm
    if m > rows:
        parts = [int8_matmul_fp_cuda_staged(
            xk[:, i:i + rows].contiguous(), wk, x_zp, alpha, block=block,
            clamp=clamp)
            for i in range(0, m, rows)]
        return (torch.cat([p[0] for p in parts], dim=1),
                torch.stack([p[1] for p in parts]).amin(),
                torch.stack([p[2] for p in parts]).amax())
    n = wk.shape[1]
    alpha, zp = _scalar(alpha, xk), _scalar(x_zp, xk)
    gm, gn = -(-m // bm), -(-n // block[1])
    y = torch.empty((b, m, n), dtype=torch.float32, device=xk.device)
    partials = torch.empty((b, gm, gn, 2), dtype=torch.float32,
                           device=xk.device)
    status = _lib("repro_int8_matmul_fp")(
        xk.data_ptr(), wk.data_ptr(), y.data_ptr(), partials.data_ptr(),
        alpha.data_ptr(), zp.data_ptr(), b, m, k, n, bm,
        torch.cuda.current_stream(xk.device).cuda_stream)
    build.check(status, "int8_matmul_fp")
    COUNTER.count += 1
    TILE_COUNTERS[bm].count += 1
    return y, partials[..., 0].amin(), partials[..., 1].amax()


def int8_matmul_fused_cuda(x2: torch.Tensor, w2: torch.Tensor,
                           x_zp: torch.Tensor, alpha: torch.Tensor,
                           bias, qparams: torch.Tensor, spec: QuantSpec,
                           block=MATMUL_DEFAULT):
    """Launch the CUDA kernel on the tile ``block`` (as
    :func:`int8_matmul_fp_cuda`); same returns as
    :func:`int8_matmul_fused_plain`."""
    _check_operands(x2, w2, "int8_matmul_fused_cuda", 2)
    block = check_tile(block)
    bm = row_tile(block[0], x2.shape[0])
    if -(-x2.shape[0] // bm) > MAX_ROW_TILES:
        raise ValueError(f"int8_matmul_fused_cuda: M = {x2.shape[0]} "
                         f"exceeds {MAX_ROW_TILES} row tiles of {bm}")
    if spec.bits != 8:
        raise ValueError(f"the kernel stores 8-bit images, got {spec.bits}")
    xk, wk = stage_operands(x2, w2)
    m, k = xk.shape
    n = wk.shape[0]
    alpha, zp = _scalar(alpha, xk), _scalar(x_zp, xk)
    qparams = qparams.to(device=xk.device,
                         dtype=torch.float32).reshape(2).contiguous()
    if bias is not None:
        if not bias.is_cuda or bias.shape != (n,):
            raise ValueError(f"bias must be a CUDA tensor of shape ({n},)")
        bias = bias.to(torch.float32).contiguous()
    gm, gn = -(-m // bm), -(-n // block[1])
    q = torch.empty((m, n), dtype=spec.storage_dtype, device=xk.device)
    partials = torch.empty((gm, gn, 2), dtype=torch.float32, device=xk.device)
    status = _lib("repro_int8_matmul_fused")(
        xk.data_ptr(), wk.data_ptr(), q.data_ptr(), partials.data_ptr(),
        alpha.data_ptr(), zp.data_ptr(),
        None if bias is None else bias.data_ptr(), qparams.data_ptr(),
        m, k, n, spec.int_min, spec.int_max, bm,
        torch.cuda.current_stream(xk.device).cuda_stream)
    build.check(status, "int8_matmul_fused")
    FUSED_COUNTER.count += 1
    FUSED_TILE_COUNTERS[bm].count += 1
    return q, partials[..., 0].amin(), partials[..., 1].amax()


def int8_matmul_int32_cuda(x3: torch.Tensor, w3: torch.Tensor,
                           x_zp: torch.Tensor, block=MATMUL_DEFAULT):
    """Launch the int32 mode on the tile ``block`` (rows clamped as
    :func:`int8_matmul_fp_cuda`); same return as
    :func:`int8_matmul_int32_plain`."""
    _check_operands(x3, w3, "int8_matmul_int32_cuda", 3)
    xk, wk = stage_operands(x3, w3)
    block = check_tile(block)
    b, m, k = xk.shape
    bm = row_tile(block[0], m)
    if -(-m // bm) > MAX_ROW_TILES:
        raise ValueError(f"int8_matmul_int32_cuda: M = {m} exceeds "
                         f"{MAX_ROW_TILES} row tiles of {bm}")
    n = wk.shape[1]
    acc = torch.empty((b, m, n), dtype=torch.int32, device=xk.device)
    status = _lib("repro_int8_matmul_int32")(
        xk.data_ptr(), wk.data_ptr(), acc.data_ptr(),
        _scalar(x_zp, xk).data_ptr(), b, m, k, n, bm,
        torch.cuda.current_stream(xk.device).cuda_stream)
    build.check(status, "int8_matmul_int32")
    INT32_COUNTER.count += 1
    return acc


EPILOGUE_BLOCK = 256 * 8     # int32 values a block of the epilogue takes


def int8_matmul_epilogue_cuda(acc: torch.Tensor, alpha: torch.Tensor):
    """Launch the int32 mode's epilogue; same returns as
    :func:`int8_matmul_epilogue_plain`."""
    if not acc.is_cuda or acc.dtype != torch.int32 or acc.numel() == 0:
        raise ValueError(f"int8_matmul_epilogue_cuda needs a non-empty CUDA "
                         f"int32 tensor, got {acc.dtype} on {acc.device}")
    acc = acc.contiguous()
    n = acc.numel()
    y = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    partials = torch.empty((-(-n // EPILOGUE_BLOCK), 2), dtype=torch.float32,
                           device=acc.device)
    status = _lib("repro_int8_matmul_epilogue")(
        acc.data_ptr(), y.data_ptr(), partials.data_ptr(),
        _scalar(alpha, acc).data_ptr(), n,
        torch.cuda.current_stream(acc.device).cuda_stream)
    build.check(status, "int8_matmul_epilogue")
    EPILOGUE_COUNTER.count += 1
    return y, partials[:, 0].amin(), partials[:, 1].amax()
