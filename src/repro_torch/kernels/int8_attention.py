"""Int8 flash attention with in-kernel hindsight statistics (port of
``repro/kernels/int8_attention.py``).

Per (q block, kv block) tile:

    int8 QK^T (int32 accumulate) -> fp32 online softmax
    -> requantize p with the PRE-COMPUTED [p_lo, p_hi] registers
    -> int8 PV (int32 accumulate)

while the same tile is reduced to the (min, max, clip, n, err, sig)
partials of the probability site.  ``attention_core_reference`` is the
plain, order-pinned version: it replays the identical block schedule and
recurrence through the shared per-block functions below, so it is both
the ``simulated`` backend's attention core and what the CUDA kernel is
held against.

Source note.  The CUDA kernel (``csrc/int8_attention.cu``) replaces the
TPU kernel ``attention_kernel`` (``repro/kernels/int8_attention.py``,
body ``_attn_kernel``).  One CUDA block per (head, q block) walks its
``width`` kv blocks in the reference's order — that loop replaces the
TPU's sequential grid axis — with GQA through ``bh // groups``.  Both
int8 contractions run on the tensor cores (``mma.sync`` u8 x s8,
``csrc/mma_int8.cuh``) with the reference's truncated zero points
restored as ``-trunc(zp) * rowsum(k)`` and ``-trunc(zp_p) * colsum(v)``;
K and V's K-major image (written by the int8 matmul's transpose kernel)
stream in by double-buffered ``cp.async``; the softmax, the requantized
probabilities and the statistics stay in registers, and the err/sig tree
keeps the reference's association (a rows-then-columns tree for
power-of-two ``bkv``, the flat tree otherwise).  A q block of 129-256
rows (the tuner's ``(256, 128)`` below S = 256) takes the kernel's tall
instantiation: each row group owns two 16-row mma tiles, whose values of
one element meet first in the tree (its rows padded to 256), and K/V
stream through one buffer.  Every other tile the reference takes (bkv in
(128, 512], bq above 256, hd in (256, 512], or a flat err/sig buffer that
does not fit beside the wide layout) runs the general instantiation
(:func:`uses_general`): CTAs of 16 q rows on dp4a, each kv block's scores
formed whole (K in sub-tiles of 64 rows) before any exp, and the CTAs'
p-site partials folded over each reference q block by the wrapper
(err/sig within 1e-4 of the reference's tree).  Every instantiation and
the plain versions take a query offset (``q_start``): a call on the
rows ``[q_start, q_start + sq)`` of the call a schedule plans (the
sequence-parallel core's rank) runs those rows' q blocks with that
call's kv walk and mask, and a first row inside a q block runs the
block's leading rows as padding that counts in no statistic.  At the slice's shape it
is bound by the per-element fp32 softmax and requantization, not by bytes
or by the card's int8 rate.

Layout: q uint8 ``[BH, sq, hd]`` (BH = B * KV * G, head-major), k/v int8
``[ZB, skv, hd]`` (ZB = B * KV).  Registers: fp32 ``[8]`` =
``[zp_q, alpha_qk, scale_p, zp_p, alpha_pv, p_lo, p_hi, spare]``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantSpec

from . import LaunchCounter, build
from . import int8_matmul as _mm

COUNTER = LaunchCounter("int8_attention")
# Launches of the general instantiation, counted beside COUNTER.
GENERAL_COUNTER = LaunchCounter("int8_attention general")

NEG_INF = -1e30
P_SPEC = QuantSpec(bits=8, symmetric=False)
STAT_SLOTS = 6
MASK_MODES = ("causal", "sliding", "prefix", "cross", "bidir")
KERNEL_MAX_BQ = 256          # bq limit of the mma instantiations (above
                             # 128: tall)
KERNEL_MAX_BKV = 128         # their bkv limit
KERNEL_MAX_NARROW_HD = 128   # the narrow instantiation's hd
KERNEL_MAX_HD = 256          # their hd limit (above 128: multiples of 16,
                             # to which the wrapper pads hd)
MAX_HD = MAX_BKV = 512       # the reference's limits: the general
                             # instantiation takes the tiles up to them
GENERAL_ROWS = 16            # q rows of one general-instantiation CTA
HD_ALIGN = 16                # the wide instantiation's hd step
SMEM_LIMIT = 232448          # a block's shared memory on the H100, bytes


# ---------------------------------------------------------------------------
# Schedule: the static block plan shared by kernel and reference.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnSchedule:
    sq: int
    skv: int
    hd: int
    bq: int
    bkv: int
    groups: int
    mode: str
    window: int
    prefix_len: int
    sm_scale: float
    width: int

    @property
    def nq(self) -> int:
        return -(-self.sq // self.bq)

    @property
    def nkv(self) -> int:
        return -(-self.skv // self.bkv)


def make_schedule(*, sq: int, skv: int, hd: int, bq: int, bkv: int,
                  groups: int, mode: str, window: int = 0,
                  prefix_len: int = 0, sm_scale: float) -> AttnSchedule:
    """Resolve block sizes and the per-q-block kv visitation width (the
    sliding mode's block-local fast path)."""
    if mode not in MASK_MODES:
        raise ValueError(f"unknown mask mode {mode!r}; expected {MASK_MODES}")
    if mode == "sliding" and window <= 0:
        raise ValueError("sliding mode requires window > 0")
    bq = max(1, min(int(bq), sq))
    bkv = max(1, min(int(bkv), skv))
    # int32 exactness headroom: accumulators stay below 2**24, exact
    # through the fp32 cast, for hd, bkv <= 512.
    if hd > 512 or bkv > 512:
        raise ValueError(f"head_dim/bkv must be <= 512 (got {hd}, {bkv})")
    nq = -(-sq // bq)
    nkv = -(-skv // bkv)
    if mode == "sliding":
        width = 1
        for i in range(nq):
            hi = min((i * bq + bq - 1) // bkv, nkv - 1)
            lo = max(0, i * bq - window + 1) // bkv
            width = max(width, hi - lo + 1)
        width = min(width, nkv)
    else:
        width = nkv
    return AttnSchedule(sq=sq, skv=skv, hd=hd, bq=bq, bkv=bkv, groups=groups,
                        mode=mode, window=int(window),
                        prefix_len=int(prefix_len), sm_scale=float(sm_scale),
                        width=width)


def _kv_block_base(i: int, sched: AttnSchedule) -> int:
    """First kv block index q block ``i`` visits."""
    if sched.mode != "sliding" or sched.width >= sched.nkv:
        return 0
    hi = min((i * sched.bq + sched.bq - 1) // sched.bkv, sched.nkv - 1)
    return min(max(hi - (sched.width - 1), 0), max(sched.nkv - sched.width, 0))


def _block_visited(i: int, ki: int, sched: AttnSchedule) -> bool:
    """Block-level skip predicate: a skipped block is provably fully
    masked for every row of the q block."""
    if sched.mode in ("cross", "bidir", "sliding"):
        return True
    causal = (ki * sched.bkv) <= (i * sched.bq + sched.bq - 1)
    if sched.mode == "prefix":
        return causal or (ki * sched.bkv) < sched.prefix_len
    return causal


def _element_mask(q_pos, k_pos, kvlen, sched: AttnSchedule):
    """Boolean attend-mask plus the runtime ``kvlen`` and static ``skv``
    bounds."""
    if sched.mode in ("cross", "bidir"):
        m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                       dtype=torch.bool, device=q_pos.device)
    elif sched.mode == "prefix":
        m = (k_pos <= q_pos) | (k_pos < sched.prefix_len)
    elif sched.mode == "sliding":
        m = (k_pos <= q_pos) & (q_pos - k_pos < sched.window)
    else:
        m = k_pos <= q_pos
    return m & (k_pos < kvlen) & (k_pos < sched.skv)


def row_blocks(sched: AttnSchedule, q_start: int, sq: int):
    """``(lead, i0, nq)`` of a call on the rows ``[q_start, q_start + sq)``
    of ``sched``'s (whole-sequence) call: they lie in its q blocks ``i0``
    to ``i0 + nq - 1``, from row ``lead`` of block ``i0``.  Every q block
    keeps the whole call's kv visitation (its base, its width, its
    skipped blocks), so the rows' ``out``, ``m`` and ``l`` are the whole
    call's, and their p-site partials, combined over the calls that
    cover the sequence, its (min, max, clip, n)."""
    if q_start < 0 or sq < 1 or q_start + sq > sched.sq:
        raise ValueError(f"rows [{q_start}, {q_start + sq}) are not within "
                         f"the schedule's {sched.sq}")
    lead = q_start % sched.bq
    return lead, q_start // sched.bq, -(-(lead + sq) // sched.bq)


def _pad_front(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    if not n:
        return x
    return F.pad(x, [0, 0] * (x.ndim - 1 - axis) + [n, 0])


# ---------------------------------------------------------------------------
# Arithmetic-order pinning.
# ---------------------------------------------------------------------------
def _fence(v: torch.Tensor) -> torch.Tensor:
    """The reference multiplies by a runtime 1.0 here to keep XLA from
    contracting the mul->add seam into an FMA.  Eager PyTorch runs every
    op as its own rounded kernel, so the seam is already pinned; the CUDA
    kernel pins it with __fmul_rn / __fadd_rn and -fmad=false."""
    return v


def _tree_sum_last2(v: torch.Tensor) -> torch.Tensor:
    """Pairwise-halving sum over the last TWO axes (zero-padded to a power
    of two) — the reference's fixed association tree."""
    shp = v.shape
    n = shp[-2] * shp[-1]
    v = v.reshape(shp[:-2] + (n,))
    p = 1
    while p < n:
        p *= 2
    if p != n:
        v = torch.cat([v, v.new_zeros(shp[:-2] + (p - n,))], dim=-1)
    while p > 1:
        p //= 2
        v = v[..., :p] + v[..., p:]
    return v[..., 0]


def _tree_sum_flat(v: torch.Tensor) -> torch.Tensor:
    return _tree_sum_last2(v.reshape(1, -1))


# ---------------------------------------------------------------------------
# The shared per-block recurrence.
# ---------------------------------------------------------------------------
def _scores_to_probs(acc_qk, mask, m_prev, alpha_qk, scale_p, zp_p):
    """Exact QK^T accumulator tile -> quantized probabilities.  Returns
    ``(rp, p, p_hat, m_new, corr)``; ``rp`` is the zero-point-corrected
    probability image (masked entries exactly 0)."""
    s = _fence(alpha_qk * acc_qk.to(torch.float32))
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    p = torch.where(mask, p, 0.0)
    p_int = torch.round(p / scale_p + zp_p).clamp(float(P_SPEC.int_min),
                                                  float(P_SPEC.int_max))
    rp = p_int.to(torch.int32) - zp_p.to(torch.int32)
    p_hat = (p_int - zp_p) * scale_p
    corr = torch.exp(m_prev - m_new)
    return rp, p, p_hat, m_new, corr


def _accumulate(acc_prev, l_prev, corr, acc_pv, rp, alpha_pv, scale_p):
    """Online-softmax carry update with separately rounded seams."""
    acc = _fence(acc_prev * corr) + _fence(alpha_pv * acc_pv.to(torch.float32))
    lsum = rp.sum(dim=-1, keepdim=True).to(torch.float32)
    l = _fence(l_prev * corr) + _fence(scale_p * lsum)
    return acc, l


def _stats_update(st, p, p_hat, sv, p_lo, p_hi):
    """Fold one tile into the (pmin, pmax, clip, n, err, sig) partials."""
    big = torch.finfo(torch.float32).max
    pmn = torch.where(sv, p, big).amin(dim=(-2, -1))
    pmx = torch.where(sv, p, -big).amax(dim=(-2, -1))
    clip = torch.where(sv & ((p < p_lo) | (p > p_hi)), 1.0, 0.0).sum(
        dim=(-2, -1))
    cnt = torch.where(sv, 1.0, 0.0).sum(dim=(-2, -1)).expand_as(pmn)
    d = p - p_hat
    err = _tree_sum_last2(_fence(torch.where(sv, d * d, 0.0)))
    sig = _tree_sum_last2(_fence(torch.where(sv, p * p, 0.0)))
    return torch.stack([torch.minimum(st[..., 0], pmn),
                        torch.maximum(st[..., 1], pmx),
                        st[..., 2] + clip,
                        st[..., 3] + cnt,
                        st[..., 4] + err,
                        st[..., 5] + sig], dim=-1)


def _stats_init(shape, device) -> torch.Tensor:
    big = torch.finfo(torch.float32).max
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.stack([z + big, z - big, z, z, z, z], dim=-1)


def reduce_pstats(partials: torch.Tensor):
    """Reduce ``[BH, nq, 6]`` partials to the site-level (mn, mx, clip, n,
    err, sig): min/max/counts exact in any order, err/sig order-pinned;
    ``(+inf, -inf, 0, 0, 0, 0)`` of an empty call's."""
    if partials.numel() == 0:
        inf = torch.tensor(float("inf"), device=partials.device)
        zero = torch.zeros((), device=partials.device)
        return inf, -inf, zero, zero, zero, zero
    return (partials[..., 0].amin(), partials[..., 1].amax(),
            partials[..., 2].sum(), partials[..., 3].sum(),
            _tree_sum_flat(partials[..., 4].reshape(-1)),
            _tree_sum_flat(partials[..., 5].reshape(-1)))


# ---------------------------------------------------------------------------
# The plain version: order-pinned replay of the kernel's schedule.
# ---------------------------------------------------------------------------
def _pad_axis(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    cur = x.shape[axis]
    if cur == size:
        return x
    pads = [0, 0] * (x.ndim - 1 - axis) + [0, size - cur]
    return F.pad(x, pads)


def empty_core(q_u8, sched: AttnSchedule, q_start: int = 0):
    """:func:`attention_core_reference`'s outputs for no q heads (a model
    rank's empty share of a padded head dim): empty, nothing launched."""
    sq = q_u8.shape[1]
    nq = row_blocks(sched, q_start, sq)[2]
    z = functools.partial(torch.zeros, dtype=torch.float32,
                          device=q_u8.device)
    return z((0, sq, sched.hd)), z((0, sq, 2)), z((0, nq, 6))


def attention_core_reference(q_u8, k_i8, v_i8, regs, kvlen, *,
                             sched: AttnSchedule, q_start: int = 0):
    """Returns ``(out fp32 [BH, sq, hd], ml fp32 [BH, sq, 2], pstats fp32
    [BH, nq, 6])``.  The int contractions run in float64, exact for these
    integer operands in any summation order.  Every q block walks its
    ``width`` kv blocks from its own base in the kernel's order; the q
    blocks advance together, one kv step at a time, and a block the
    schedule skips keeps its carries (the same values as skipping it).

    ``q_u8``'s rows are the rows ``[q_start, q_start + sq)`` of the call
    ``sched`` plans (:func:`row_blocks`; the sequence-parallel core's
    rank): their ``out`` and ``ml`` are that call's rows, and ``pstats``
    covers the q blocks they lie in, each over these rows only."""
    S = sched
    bh, sq = q_u8.shape[0], q_u8.shape[1]
    if bh == 0:
        return empty_core(q_u8, sched, q_start)
    lead, i0, nq = row_blocks(S, q_start, sq)
    zb = bh // S.groups
    dev = q_u8.device
    f64 = torch.float64
    qz = _pad_axis(_pad_front(q_u8, lead, 1), nq * S.bq, 1).reshape(
        zb, S.groups, nq, S.bq, S.hd)
    kz = _pad_axis(k_i8, S.nkv * S.bkv, 1).reshape(zb, S.nkv, S.bkv, S.hd)
    vz = _pad_axis(v_i8, S.nkv * S.bkv, 1).reshape(zb, S.nkv, S.bkv, S.hd)
    regs = regs.reshape(-1).to(torch.float32)
    zp_q, alpha_qk, scale_p, zp_p, alpha_pv, p_lo, p_hi = (
        regs[j] for j in range(7))
    kvl = kvlen.reshape(()).to(device=dev)
    # q block i's rows and kv block ki's columns: [nq, bq, 1], [nq, 1, bkv]
    q_pos = (torch.arange(i0, i0 + nq, device=dev) * S.bq)[:, None, None] \
        + torch.arange(S.bq, device=dev)[None, :, None]
    row_ok = (q_pos >= q_start) & (q_pos < q_start + sq)
    cols = torch.arange(S.bkv, device=dev)[None, None, :]
    base = [_kv_block_base(i0 + i, S) for i in range(nq)]

    rq = (qz.to(torch.int32) - zp_q.to(torch.int32)).to(f64)
    m = torch.full((zb, S.groups, nq, S.bq, 1), NEG_INF,
                   dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((zb, S.groups, nq, S.bq, S.hd), dtype=torch.float32,
                      device=dev)
    st = _stats_init((zb, S.groups, nq), dev)
    for t in range(S.width):
        kis = [b + t for b in base]
        vis = [_block_visited(i0 + i, ki, S) for i, ki in enumerate(kis)]
        if not any(vis):
            continue
        ki = torch.tensor(kis, device=dev)
        rk = kz[:, ki].to(f64)                        # [zb, nq, bkv, hd]
        rv = vz[:, ki].to(f64)
        acc_qk = torch.einsum("zgiqh,zikh->zgiqk", rq, rk)
        k_pos = (ki * S.bkv)[:, None, None] + cols
        mask = _element_mask(q_pos, k_pos, kvl, S)
        rp, p, p_hat, m_new, corr = _scores_to_probs(
            acc_qk, mask, m, alpha_qk, scale_p, zp_p)
        acc_pv = torch.einsum("zgiqk,zikh->zgiqh", rp.to(f64), rv)
        acc_new, l_new = _accumulate(acc, l, corr, acc_pv, rp, alpha_pv,
                                     scale_p)
        sv = row_ok & (k_pos < S.skv)
        st_new = _stats_update(st, p, p_hat, sv, p_lo, p_hi)
        keep = torch.tensor(vis, device=dev)
        m = torch.where(keep[:, None, None], m_new, m)
        l = torch.where(keep[:, None, None], l_new, l)
        acc = torch.where(keep[:, None, None], acc_new, acc)
        st = torch.where(keep[:, None], st_new, st)
    # [ZB, G, nq, bq, ...] is the kernel's element order [BH, sq, ...]
    rows = slice(lead, lead + sq)
    out = (acc / l.clamp(min=1e-30)).reshape(bh, nq * S.bq, S.hd)[:, rows]
    ml = torch.cat([m, l], dim=-1).reshape(bh, nq * S.bq, 2)[:, rows]
    pstats = st.reshape(bh, nq, STAT_SLOTS)
    return out.contiguous(), ml.contiguous(), pstats.contiguous()


# ---------------------------------------------------------------------------
# The recompute-based backward, shared by both backends.  The reference
# writes it in jnp (no Pallas kernel), so the port writes plain PyTorch.
# The clipped STE through the q/k/v quantizers is applied by the enclosing
# site quantizers; inside the core the p quantization and the softmax
# maxima are straight-through constants, so the cotangents are the flash
# backward evaluated on p = exp(s - m_final), with s recomputed through the
# same exact int8 QK^T as the forward.
# ---------------------------------------------------------------------------
def attention_core_backward(qh, kh, vh, q_u8, k_i8, v_i8, regs, kvlen,
                            out, ml, g_out, *, sched: AttnSchedule,
                            z_chunk: Optional[int] = None, q_start: int = 0):
    """Returns ``(dq [BH, sq, hd], dk [ZB, skv, hd], dv [ZB, skv, hd])``,
    fp32 cotangents w.r.t. the on-grid (dequantized) q/k/v values, over
    the reference's ``(bq, bkv)`` blocks.  Each block pair's terms are
    computed for a chunk of q blocks against every kv block at once (a
    pair the mask kills gives exact zeros), then summed in the
    reference's order: ``dq_i`` over the kv blocks ``j`` in order,
    ``dk_j`` and ``dv_j`` over the q blocks ``i`` in order.  The QK^T
    recompute runs in float64, exact for these integer operands.

    ``z_chunk`` kv heads (default: all ``ZB``) go through the products at
    once.  The model passes one batch row's kv heads: every product then
    has the same shapes whatever the batch, so a row's cotangents do not
    depend on the rows beside it (the card's batched GEMMs pick their
    algorithms by shape), and a data-parallel rank's are the one-process
    step's.

    ``q_start``: the rows are ``[q_start, q_start + sq)`` of ``sched``'s
    call, as :func:`attention_core_reference` takes them; ``dk`` and
    ``dv`` are then these rows' share, which the calls covering the
    sequence sum.  No q heads (a model rank's empty share): ``dk`` and
    ``dv`` are zeros."""
    if q_u8.shape[0] == 0:
        return (torch.zeros_like(qh, dtype=torch.float32),
                torch.zeros_like(kh, dtype=torch.float32),
                torch.zeros_like(vh, dtype=torch.float32))
    zb = k_i8.shape[0]
    zc = zb if z_chunk is None else z_chunk
    if zc >= zb:
        return _core_backward(qh, kh, vh, q_u8, k_i8, regs, kvlen, out, ml,
                              g_out, sched, q_start)
    g, parts = sched.groups, []
    for z0 in range(0, zb, zc):
        zs, qs = slice(z0, z0 + zc), slice(z0 * g, (z0 + zc) * g)
        parts.append(_core_backward(
            qh[qs], kh[zs], vh[zs], q_u8[qs], k_i8[zs], regs, kvlen,
            out[qs], ml[qs], g_out[qs], sched, q_start))
    return tuple(torch.cat(t) for t in zip(*parts))


def _core_backward(qh, kh, vh, q_u8, k_i8, regs, kvlen, out, ml, g_out,
                   sched: AttnSchedule, q_start: int = 0):
    S = sched
    bh, sq = q_u8.shape[0], q_u8.shape[1]
    lead, i0, nq = row_blocks(S, q_start, sq)
    zb = bh // S.groups
    dev = q_u8.device
    f32, f64 = torch.float32, torch.float64
    sqp, skp = nq * S.bq, S.nkv * S.bkv

    def qsplit(x, d):
        return _pad_axis(_pad_front(x, lead, 1), sqp, 1).reshape(
            zb, S.groups, nq, S.bq, d)

    def ksplit(x, d):
        return _pad_axis(x, skp, 1).reshape(zb, S.nkv, S.bkv, d)

    gf = g_out.to(f32)
    d_row = torch.einsum("bsh,bsh->bs", gf, out.to(f32))
    qz = qsplit(q_u8, S.hd)
    qhz = qsplit(qh.to(f32), S.hd)
    gz = qsplit(gf, S.hd)
    mz = qsplit(ml[..., 0:1], 1)                       # [ZB, G, nq, bq, 1]
    lz = qsplit(ml[..., 1:2], 1)
    dz = qsplit(d_row[..., None], 1)
    kz = ksplit(k_i8, S.hd).to(f64)
    khz = ksplit(kh.to(f32), S.hd)
    vhz = ksplit(vh.to(f32), S.hd)
    regs = regs.reshape(-1).to(f32)
    zp_q, alpha_qk = regs[0], regs[1]
    kvl = kvlen.reshape(()).to(device=dev)
    # kv positions [nkv, 1, bkv]; q positions per chunk [ci, 1, bq, 1]
    k_pos = (torch.arange(S.nkv, device=dev) * S.bkv)[:, None, None] + \
        torch.arange(S.bkv, device=dev)[None, None, :]
    rows = torch.arange(S.bq, device=dev)[:, None]
    # q blocks per chunk: ~2**26 score elements at a time
    per_block = zb * S.groups * S.nkv * S.bq * S.bkv
    ci = max(1, min(nq, (1 << 26) // per_block))

    dk_acc = torch.zeros((zb, S.nkv, S.bkv, S.hd), dtype=f32, device=dev)
    dv_acc = torch.zeros_like(dk_acc)
    dqs = []
    for c0 in range(0, nq, ci):
        sl = slice(c0, min(c0 + ci, nq))
        n = sl.stop - c0
        rq = (qz[:, :, sl].to(torch.int32) - zp_q.to(torch.int32)).to(f64)
        qh_i, g_i = qhz[:, :, sl], gz[:, :, sl]      # [ZB, G, n, bq, hd]
        # [ZB, G, n, 1, bq, 1] against [ZB, G, n, nkv, bq, bkv] blocks
        m_i, l_i, d_i = (t[:, :, sl, None] for t in (mz, lz, dz))
        acc_qk = torch.einsum("zgiqh,zjkh->zgijqk", rq, kz)
        s = _fence(alpha_qk * acc_qk.to(f32))
        del acc_qk
        q_pos = (torch.arange(i0 + c0, i0 + c0 + n, device=dev) * S.bq)[
            :, None, None, None] + rows[None, None]
        # Padded q rows (outside the call's) carry zero (m, l) residuals:
        # mask them, or p / max(l, eps) overflows into NaN cotangents.
        mask = _element_mask(q_pos, k_pos[None], kvl, S) & \
            (q_pos >= q_start) & (q_pos < q_start + sq)
        p = torch.where(mask, torch.exp(s - m_i), 0.0)
        del s, mask
        r = p / l_i.clamp(min=1e-30)
        del p
        d_ov = torch.einsum("zgiqh,zjkh->zgijqk", g_i, vhz)
        ds = (r * (d_ov - d_i)) * S.sm_scale
        del d_ov
        cq = torch.einsum("zgijqk,zjkh->zgijqh", ds, khz)
        ck = torch.einsum("zgijqk,zgiqh->zijkh", ds, qh_i)
        cv = torch.einsum("zgijqk,zgiqh->zijkh", r, g_i)
        del ds, r
        dq_c = torch.zeros((zb, S.groups, n, S.bq, S.hd), dtype=f32,
                           device=dev)
        for j in range(S.nkv):
            dq_c = dq_c + cq[:, :, :, j]
        for t in range(n):
            dk_acc = dk_acc + ck[:, t]
            dv_acc = dv_acc + cv[:, t]
        dqs.append(dq_c)
        del cq, ck, cv
    dq = torch.cat(dqs, dim=2).reshape(bh, sqp, S.hd)[:, lead:lead + sq]
    dk = dk_acc.reshape(zb, skp, S.hd)[:, :S.skv]
    dv = dv_acc.reshape(zb, skp, S.hd)[:, :S.skv]
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------
_MODE_CODE = {"causal": 0, "sliding": 1, "prefix": 2, "cross": 3, "bidir": 4}


def bind(lib: ctypes.CDLL, general: bool = False):
    """``lib``'s C entry ``repro_int8_attention`` (``general``: the
    general instantiation's, ``repro_int8_attention_general``) with its
    signature."""
    fn = lib.repro_int8_attention_general if general \
        else lib.repro_int8_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ci] * 13 + [vp]
        fn.restype = ctypes.c_int
        for name, n in (("repro_int8_attention_smem", 3),
                        ("repro_int8_attention_general_smem", 2)):
            smem = getattr(lib, name)
            smem.argtypes = [ci] * n
            smem.restype = ci
    return fn


def check_kernel_tiles(sched: AttnSchedule) -> None:
    """Raise where the reference's schedule raises (hd or bkv above 512,
    with its message): the CUDA kernel takes every other tile, the mma
    instantiations up to bq 256, bkv 128 and hd 256, the general one the
    rest (:func:`uses_general`)."""
    if sched.hd > MAX_HD or sched.bkv > MAX_BKV:
        raise ValueError(f"head_dim/bkv must be <= 512 (got {sched.hd}, "
                         f"{sched.bkv})")


def kernel_head_dim(hd: int, general: bool = False) -> int:
    """The head dim the kernel runs for ``hd``: ``hd`` up to 128 (the
    narrow instantiation), above it, or on the general instantiation,
    ``hd`` rounded up to a multiple of 16."""
    if hd <= KERNEL_MAX_NARROW_HD and not general:
        return hd
    return -(-hd // HD_ALIGN) * HD_ALIGN


def uses_general(sched: AttnSchedule, lib=None) -> bool:
    """True when ``sched``'s tile runs the general instantiation: bq above
    256, bkv above 128, hd above 256, or (with the library ``lib`` to ask)
    an mma instantiation's shared memory above the card's."""
    S = sched
    if S.bq > KERNEL_MAX_BQ or S.bkv > KERNEL_MAX_BKV or \
            S.hd > KERNEL_MAX_HD:
        return True
    if lib is None:
        return False
    bind(lib)
    return lib.repro_int8_attention_smem(kernel_head_dim(S.hd), S.bq,
                                         S.bkv) > SMEM_LIMIT


def fold_partials(parts: torch.Tensor) -> torch.Tensor:
    """The general instantiation's per-CTA partials ``[BH, nq, nsub, 6]``
    folded over each reference q block's CTAs: min, max, and the sums of
    clip, n, err and sig -> ``[BH, nq, 6]``."""
    return torch.stack([parts[..., 0].amin(-1), parts[..., 1].amax(-1),
                        *(parts[..., j].sum(-1) for j in range(2, 6))],
                       dim=-1)


def launch(fn, q_u8, k_i8, vt, regs, kvl, *, sched: AttnSchedule,
           general: bool = False, q_start: int = 0, row_lo: int = 0):
    """One launch of the C entry ``fn`` on operands already in the
    kernel's form: q and k 16-byte aligned, ``vt`` V's K-major image,
    ``regs`` fp32 [8], ``kvl`` int32 [1], all on the card (``general``:
    ``fn`` is the general instantiation's, whose partials are folded
    here).  ``q_u8``'s rows start at the position ``q_start`` of
    ``sched``'s call (a multiple of ``bq``), and its rows below
    ``row_lo`` are padding (no statistics).  Returns ``(out, ml,
    pstats)``; counts nothing."""
    S = sched
    bh, sq, dev = q_u8.shape[0], q_u8.shape[1], q_u8.device
    nq = -(-sq // S.bq)
    out = torch.empty((bh, sq, S.hd), dtype=torch.float32, device=dev)
    ml = torch.empty((bh, sq, 2), dtype=torch.float32, device=dev)
    nsub = -(-S.bq // GENERAL_ROWS) if general else 1
    pstats = torch.empty((bh, nq, nsub, STAT_SLOTS), dtype=torch.float32,
                         device=dev)
    status = fn(q_u8.data_ptr(), k_i8.data_ptr(), vt.data_ptr(),
                regs.data_ptr(), kvl.data_ptr(), out.data_ptr(),
                ml.data_ptr(), pstats.data_ptr(),
                bh, sq, S.skv, S.hd, S.bq, S.bkv, S.groups,
                _MODE_CODE[S.mode], S.window, S.prefix_len, S.width,
                q_start, row_lo, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "int8_attention")
    return out, ml, fold_partials(pstats) if general else pstats[:, :, 0]


def attention_cuda(q_u8, k_i8, v_i8, regs, kvlen, *, sched: AttnSchedule,
                   q_start: int = 0):
    """Launch the CUDA kernel; same returns as
    :func:`attention_core_reference` (``q_start`` too: the kernel takes
    the rows' first q block's position, and a call whose first row is
    not on a block boundary runs with that block's leading rows as zero
    padding that counts in no statistic).

    A head dim in (128, 256] off the multiples of 16 (any head dim on the
    general instantiation) runs padded to the next one
    (:func:`kernel_head_dim`): zero K columns add 0 to every score ``(q -
    zp_q) . k`` and leave ``rowsum(k)`` as it was, and zero V columns add
    output columns that are cut, so the scores, ``(m, l)`` and the p-site
    statistics are those of the unpadded core."""
    S = sched
    if not (q_u8.is_cuda and k_i8.is_cuda and v_i8.is_cuda):
        raise ValueError("attention_cuda needs CUDA tensors")
    if (q_u8.dtype, k_i8.dtype, v_i8.dtype) != (torch.uint8, torch.int8,
                                                torch.int8):
        raise TypeError("attention_cuda takes uint8 q and int8 k/v")
    check_kernel_tiles(S)
    bh, sq = q_u8.shape[0], q_u8.shape[1]
    lead, i0, _ = row_blocks(S, q_start, sq)
    if q_u8.shape != (bh, sq, S.hd) or bh % S.groups or \
            k_i8.shape != (bh // S.groups, S.skv, S.hd) or \
            v_i8.shape != k_i8.shape:
        raise ValueError(f"attention shapes {tuple(q_u8.shape)}, "
                         f"{tuple(k_i8.shape)} do not match {S}")
    lib = build.library("int8_attention")
    general = uses_general(S, lib)
    hd = kernel_head_dim(S.hd, general)
    if hd != S.hd:
        pad = (0, hd - S.hd)
        q_u8, k_i8, v_i8 = (F.pad(t, pad) for t in (q_u8, k_i8, v_i8))
        out, ml, pstats = attention_cuda(
            q_u8, k_i8, v_i8, regs, kvlen,
            sched=dataclasses.replace(S, hd=hd), q_start=q_start)
        return out[..., :S.hd].contiguous(), ml, pstats
    fn = bind(lib, general)
    dev = q_u8.device
    q_u8, k_i8 = _mm._aligned(_pad_front(q_u8, lead, 1)), _mm._aligned(k_i8)
    # V's K-major image [ZB, hd, skv rounded up to 16]: the PV product's
    # B operand, kv contiguous.
    vt = _mm.weight_kmajor_cuda(v_i8)
    regs = regs.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    kvl = kvlen.to(device=dev, dtype=torch.int32).reshape(1).contiguous()
    out, ml, pstats = launch(fn, q_u8, k_i8, vt, regs, kvl, sched=S,
                             general=general, q_start=i0 * S.bq,
                             row_lo=lead)
    COUNTER.count += 1
    GENERAL_COUNTER.count += general
    if lead:
        out, ml = out[:, lead:].contiguous(), ml[:, lead:].contiguous()
    return out, ml, pstats
