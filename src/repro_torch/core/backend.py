"""Execution-backend dispatch (port of ``repro/core/backend.py``).

Every quantization site has two implementations:

  ``simulated``  plain PyTorch fake-quant, the int contractions evaluated
                 exactly in float64;
  ``fused``      the kernels of ``repro_torch.kernels`` through ``ops``:
                 the hand-written CUDA kernels for CUDA tensors, their
                 plain versions for CPU tensors.  Legal only for
                 fully-static policies.

Both evaluate the same arithmetic — ``round/floor(x / s + zp [+ u])`` with
shared registers, exact min/max, and ``alpha * (int32 contraction)`` — so
they agree bit for bit wherever the arithmetic is exact.

Backward half: the forward quantizers take the clipped STE (gradient
masked to the grid's ``[lo, hi]``), the gradient quantizer
(:func:`grad_quantize`) runs in every gradient barrier's backward with the
stochastic-rounding noise both backends draw from :func:`site_noise`, and
the int8 contraction, the int8 convolution and the attention core have
the reference's custom backward passes as ``torch.autograd.Function``s.
The forward statistics and ranges are computed on detached tensors: only
the on-grid values carry the autograd graph.

Under a model group (``runtime.sharding.model_parallel``) a site may
hold a shard of its tensor (``model_dim``: the dim a model rank holds a
slice of; None = every rank holds it whole).  A range that reads the
current tensor takes the (min, max) over the whole mesh, a gradient
site's noise is this rank's slice of the global site's, and a whole
site's additive telemetry counters count on model rank 0 only.  A weight
shard is quantized on the global (min, max).  A rank's empty share of a
padded head dim (``runtime.sharding.split_range``) launches no kernel,
takes part in every collective with a neutral ``(+inf, -inf)`` and
emits an unvisited statistics vector (zero counters), so no statistic
sees it.  :func:`qmatmul` has Megatron's column-parallel form (the
rank's output columns; ``dx`` summed over the model group in fp32
before its cast) and row-parallel form (the rank's K rows: int32
partials summed exactly, then the epilogue), and an expert-parallel one
(the rank's experts, nothing to reduce); under the sequence-parallel
residual a row-parallel product's partials are reduce-scattered onto
the rank's rows of the sequence and a column-parallel product's ``dx``
onto the rows its input was gathered from (``seq_dim``).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.runtime import sharding
from repro_torch.telemetry import metrics

from . import estimators, quant
from .state import INITED, QMAX, QMIN, pack_stats

SIMULATED = "simulated"
FUSED = "fused"
BACKENDS = (SIMULATED, FUSED)


def _ops():
    from repro_torch.kernels import ops
    return ops


class QTensor(NamedTuple):
    """Integer image of an on-grid tensor plus its quant registers."""

    q: torch.Tensor            # uint8 (asymmetric) / int8 (symmetric)
    scale: torch.Tensor        # fp32 scalar register
    zero_point: torch.Tensor   # fp32 scalar register (integral-valued)


def dequantize_qtensor(qt: QTensor) -> torch.Tensor:
    """fp32 values of an image: ``quant.dequantize``'s two ops, from the
    registers already derived from the range (in place on the fp32 copy:
    one tensor of transients, not two)."""
    v = qt.q.to(torch.float32, copy=True)
    return v.sub_(qt.zero_point).mul_(qt.scale)


# ---------------------------------------------------------------------------
# Policy validation.
# ---------------------------------------------------------------------------
def validate(policy) -> None:
    """Raise ``ValueError`` if the policy's backend selection is illegal."""
    if policy.backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {policy.backend!r}; expected one of {BACKENDS}")
    if policy.backend != FUSED:
        return
    dynamic = []
    if policy.quantize_acts and not policy.act_estimator.is_static:
        dynamic.append(f"act_estimator={policy.act_estimator.kind!r}")
    if policy.quantize_grads and not policy.grad_estimator.is_static:
        dynamic.append(f"grad_estimator={policy.grad_estimator.kind!r}")
    if dynamic:
        raise ValueError(
            "backend='fused' requires fully-static quantization ranges "
            "(the single-pass kernels consume pre-computed quant registers; "
            "a dynamic estimator needs the whole tensor before choosing a "
            f"range — the two-pass dataflow of paper eq. 5). Dynamic: "
            f"{', '.join(dynamic)}. Use estimators from "
            f"{estimators.STATIC_ESTIMATORS} or backend='simulated'.")
    tele = policy.telemetry
    if tele.enabled and tele.guard and tele.mode == "dynamic":
        raise ValueError(
            "backend='fused' cannot honor the overflow guard's 'dynamic' "
            "fallback mode (it re-quantizes with current min-max, which is "
            "a dynamic range). Use guard mode='widen', which keeps ranges "
            "static, or backend='simulated'.")


def int8_matmul_eligible(policy) -> bool:
    """True iff the act/weight quantizers produce operands on the int8
    matmul layout (asymmetric uint8 x symmetric int8)."""
    return bool(
        policy.enabled
        and policy.quantize_acts and policy.quantize_weights
        and policy.act_spec.bits == 8 and not policy.act_spec.symmetric
        and policy.weight_spec.bits == 8 and policy.weight_spec.symmetric
        and not policy.int8_weight_gather)


# ---------------------------------------------------------------------------
# Per-site stochastic-rounding noise (shared by both backends, so the
# quantized gradients are identical).
# ---------------------------------------------------------------------------
def site_seed(seed: int, salt: int) -> int:
    """The reference's ``site_key`` mixing, ``uint32(seed) ^ (salt *
    0x9E3779B9)``, as a 32-bit generator seed."""
    return (int(seed) & 0xFFFFFFFF) ^ ((salt * 0x9E3779B9) & 0xFFFFFFFF)


def site_noise(seed: int, shape, device) -> torch.Tensor:
    """fp32 noise ``u ~ U[0, 1)`` of one gradient site, from a generator on
    ``device`` seeded with the mixed site seed.  Every gradient quantizer
    draws its noise here, keyed by (site seed, shape)."""
    gen = torch.Generator(device=device).manual_seed(site_seed(seed, 1))
    return torch.rand(tuple(shape), generator=gen, device=device,
                      dtype=torch.float32)


def shard_noise(seed: int, shape, device, batch_dim: int = 0,
                model_dim=None) -> torch.Tensor:
    """:func:`site_noise` of a gradient site whose ``batch_dim`` is this
    rank's shard under data parallelism, and whose ``model_dim`` (if not
    None) its shard under model parallelism: the global site's noise
    drawn (``N`` times the rows; ``M`` times the model dim, or the whole
    size where ``model_dim`` is ``(dim, whole size)``, a padded head
    dim whose shares differ), and this rank's rows and share of it kept,
    so a rank's stochastic rounding is the single-device step's on the
    same elements."""
    dp = sharding.dp_shard()
    mp = None if model_dim is None else sharding.mp_shard()
    if dp is None and mp is None:
        return site_noise(seed, shape, device)
    full = list(shape)
    if dp is not None:
        full[batch_dim] *= dp[1]
    if mp is not None and isinstance(model_dim, tuple):
        model_dim, whole = model_dim
        full[model_dim] = whole
    elif mp is not None:
        full[model_dim] *= mp[1]
    u = site_noise(seed, full, device)
    if dp is not None:
        u = sharding.shard_rows(u, batch_dim)
    return u if mp is None else sharding.mp_slice(u, model_dim)


def _global_minmax(cfg, leaf, tele, xf, local=None):
    """Under data or model parallelism, the (min, max) over every rank of
    the mesh where the site's range reads the tensor this step
    (``estimators.reads_current``): a blocking all_reduce a mesh axis (a
    model-replicated tensor's is its own).  Elsewhere ``local`` (the
    kernel's partials, or ``None``: the caller reduces ``xf`` itself),
    which ``steps.dp_combine_stats`` merges over the ranks once a step,
    so an initialized hindsight site waits on no collective."""
    if (sharding.dp_shard() is None and sharding.mp_shard() is None) or \
            not estimators.reads_current(cfg, leaf, tele):
        return local
    if local is None:
        local = quant.tensor_minmax(xf)
    return sharding.mp_minmax(*sharding.dp_minmax(*local))


def _whole_site(st: torch.Tensor, model_dim) -> torch.Tensor:
    """A site's stats; where every model rank holds the tensor whole
    (``model_dim`` None), its counters on model rank 0 only
    (``sharding.mp_replicated_stats``)."""
    return sharding.mp_replicated_stats(st) if model_dim is None else st


# ---------------------------------------------------------------------------
# The quantizer forward: on-grid values, integer image, observed min/max.
# ---------------------------------------------------------------------------
def canonical(x: torch.Tensor) -> torch.Tensor:
    """fp32 view of ``x`` rounded to its nominal dtype precision, detached.

    The reference needs ``lax.reduce_precision`` because XLA may elide a
    ``f32 -> bf16 -> f32`` round trip.  In eager PyTorch a bf16 tensor is
    stored as bf16, so its fp32 view already holds the bf16-rounded
    values: the cast IS the round trip."""
    return x.detach().to(torch.float32)


def _quantizer_fwd(x, qmin, qmax, spec: quant.QuantSpec, fused: bool,
                   values: bool = True):
    """Returns ``(xq, q, obs_min, obs_max)``; ``xq`` has ``x``'s dtype and
    the clipped-STE gradient (``None`` unless ``values``)."""
    xf = canonical(x)
    if fused and spec.bits <= 8:
        q, mn, mx = _ops().fused_quantize(xf, qmin, qmax, spec=spec)
    else:
        q = quant.quantize(xf, qmin, qmax, spec)
        if spec.bits <= 8:
            q = q.to(spec.storage_dtype)
        mn, mx = quant.tensor_minmax(xf)
    scale, zp = quant.scale_zero_point(qmin, qmax, spec)
    xq = quant.on_grid(x, q, scale, zp, spec) if values else None
    return xq, q, mn, mx


# ---------------------------------------------------------------------------
# Q_Y: activation quantizer sites.
# ---------------------------------------------------------------------------
def act_quantize(policy, x, leaf, step, model_dim: Optional[int] = None):
    """The classic activation site; returns ``(xq, stats, qtensor)``."""
    return site_quantize(policy, x, leaf, step, name="act",
                         model_dim=model_dim)


def site_quantize(policy, x: torch.Tensor, leaf: torch.Tensor, step, *,
                  cfg=None, spec=None, name: str = "act",
                  model_dim: Optional[int] = None):
    """Activation-quantizer site with an overridable (estimator, spec).

    Simulated: estimator ranges -> fake-quant -> stats reduction.  Fused:
    one pass of the quantize kernel with the leaf's pre-computed range;
    the kernel's partials are the next-step statistics (no separate
    min/max pass).  ``model_dim``: see the module docstring."""
    cfg = policy.act_estimator if cfg is None else cfg
    spec = policy.act_spec if spec is None else spec
    tele = policy.telemetry
    if policy.backend == FUSED:
        xq, q, used_qmin, used_qmax, obs = _fused_static_quant(
            cfg, spec, x, leaf, step, tele)
        xf = x          # unread: the statistics are the kernel's partials
    else:
        xf = canonical(x)
        obs = _global_minmax(cfg, leaf, tele, xf)
        used_qmin, used_qmax = estimators.ranges(
            cfg, leaf, xf, spec, step, telemetry=tele, observed=obs,
            split_model=model_dim is not None)
        xq, q, mn, mx = _quantizer_fwd(x, used_qmin, used_qmax, spec,
                                       fused=False)
        obs = (mn, mx) if obs is None else obs
    if x.numel() == 0:
        st = _unvisited(policy, x.device)
    else:
        st = estimators.stats(cfg, xf, used_qmin, used_qmax, observed=obs)
        if tele.enabled:
            # Sampled on a prefix of x itself: no full fp32 copy on fused.
            st = metrics.site_stats(x, used_qmin, used_qmax, spec, st,
                                    tele.sample)
    scale, zp = quant.scale_zero_point(used_qmin, used_qmax, spec)
    return xq, _whole_site(st, model_dim), QTensor(q, scale, zp)


def _unvisited(policy, device) -> torch.Tensor:
    """The statistics of a rank's empty share: not visited, zero
    counters."""
    return torch.zeros((policy.stat_width,), dtype=torch.float32,
                       device=device)


def _fused_static_quant(cfg, spec, x, leaf, step, tele):
    """Static single-pass quantization.  While the leaf is uninitialized
    the paper's first-batch rule re-quantizes with the observed range; the
    reference selects that with ``lax.cond``, here it is a host-side
    branch on ``leaf[INITED]`` (one device->host scalar read per site
    call on a CUDA tensor)."""
    if cfg.kind == estimators.FIXED:
        qmin = torch.tensor(cfg.fixed_min, dtype=torch.float32,
                            device=leaf.device)
        qmax = torch.tensor(cfg.fixed_max, dtype=torch.float32,
                            device=leaf.device)
        xq, q, mn, mx = _quantizer_fwd(x, qmin, qmax, spec, fused=True)
        return xq, q, qmin, qmax, (mn, mx)
    xq, q, mn, mx = _quantizer_fwd(x, leaf[QMIN], leaf[QMAX], spec,
                                   fused=True)
    mn, mx = _global_minmax(cfg, leaf, tele, None, (mn, mx))
    qmin, qmax = estimators.ranges(cfg, leaf, x, spec, step, telemetry=tele,
                                   observed=(mn, mx))
    if not bool(leaf[INITED] > 0.5):
        xq, q = _quantizer_fwd(x, mn, mx, spec, fused=True)[:2]
    return xq, q, qmin, qmax, (mn, mx)


# ---------------------------------------------------------------------------
# Q_W: weight quantizer (current min-max).
# ---------------------------------------------------------------------------
def weight_quantize(policy, w: torch.Tensor, sharded: bool = False
                    ) -> tuple[Optional[torch.Tensor], QTensor]:
    """``(wq, qtensor)``: the weight's int8 image and registers on the
    symmetric grid, and its on-grid values (``w``'s dtype, clipped-STE
    gradient) when a gradient of ``w`` is being recorded — else ``None``:
    an inference contraction reads the image only, and a consumer that
    needs values takes :func:`dequantize_qtensor` (the same fp32 ops).
    ``sharded``: ``w`` is this model rank's shard, quantized on the whole
    weight's (min, max) (an exact all_reduce), so its image is the slice
    of the whole weight's."""
    spec = policy.weight_spec
    mn, mx = quant.tensor_minmax(canonical(w))
    if sharded:
        mn, mx = sharding.mp_minmax(mn, mx)
    wq, q, _, _ = _quantizer_fwd(
        w, mn, mx, spec, fused=(policy.backend == FUSED),
        values=torch.is_grad_enabled() and w.requires_grad)
    scale, zp = quant.scale_zero_point(mn, mx, spec)
    return wq, QTensor(q, scale, zp)


# ---------------------------------------------------------------------------
# Q_G: gradient quantizer (runs inside the barrier's backward pass).
# ---------------------------------------------------------------------------
def grad_quantize(policy, g: torch.Tensor, leaf: torch.Tensor, seed: int,
                  step, batch_dim: int = 0, model_dim: Optional[int] = None):
    """Quantize a cotangent; returns ``(gq, stats)``.  Both backends draw
    the stochastic-rounding noise from :func:`site_noise` with the same
    site seed, so the quantized gradients are bit-identical; ``batch_dim``
    is the dim a data-parallel rank holds a shard of, ``model_dim`` the
    one a model rank does (:func:`shard_noise`)."""
    cfg, spec = policy.grad_estimator, policy.grad_spec
    tele = policy.telemetry
    noise = shard_noise(seed, g.shape, g.device, batch_dim, model_dim) \
        if spec.stochastic else None
    gf = canonical(g)
    if policy.backend == FUSED and spec.bits <= 8:
        gq, used_qmin, used_qmax, obs = _fused_grad_quant(
            cfg, spec, g, gf, leaf, step, tele, noise)
    else:
        obs = _global_minmax(cfg, leaf, tele, gf)
        used_qmin, used_qmax = estimators.ranges(
            cfg, leaf, gf, spec, step, telemetry=tele, observed=obs,
            split_model=model_dim is not None)
        gq = quant.fake_quant_raw(gf, used_qmin, used_qmax, spec,
                                  noise).to(g.dtype)
    if g.numel() == 0:
        st = _unvisited(policy, g.device)
    else:
        st = estimators.stats(cfg, gf, used_qmin, used_qmax, observed=obs)
        if tele.enabled:
            st = metrics.site_stats(gf, used_qmin, used_qmax, spec, st,
                                    tele.sample)
    return gq, _whole_site(st, model_dim)


def _kernel_quant(spec, xf, qmin, qmax, noise):
    ops = _ops()
    if noise is not None:
        return ops.stochastic_quantize(xf, qmin, qmax, noise, spec=spec)
    return ops.fused_quantize(xf, qmin, qmax, spec=spec)


def _fused_grad_quant(cfg, spec, g, gf, leaf, step, tele, noise):
    """Static single-pass gradient quantization; an uninitialized leaf
    re-runs the kernel with the observed range (the reference's
    ``lax.cond``, here a host-side branch on ``leaf[INITED]``)."""
    if cfg.kind == estimators.FIXED:
        qmin = torch.tensor(cfg.fixed_min, dtype=torch.float32,
                            device=g.device)
        qmax = torch.tensor(cfg.fixed_max, dtype=torch.float32,
                            device=g.device)
        q, mn, mx = _kernel_quant(spec, gf, qmin, qmax, noise)
        gq = quant.dequantize(q, qmin, qmax, spec).to(g.dtype)
        return gq, qmin, qmax, (mn, mx)
    q0, mn, mx = _kernel_quant(spec, gf, leaf[QMIN], leaf[QMAX], noise)
    mn, mx = _global_minmax(cfg, leaf, tele, None, (mn, mx))
    qmin, qmax = estimators.ranges(cfg, leaf, gf, spec, step, telemetry=tele,
                                   observed=(mn, mx))
    if bool(leaf[INITED] > 0.5):
        gq = quant.dequantize(q0, leaf[QMIN], leaf[QMAX], spec)
    else:
        q1 = _kernel_quant(spec, gf, mn, mx, noise)[0]
        gq = quant.dequantize(q1, mn, mx, spec)
    return gq.to(g.dtype), qmin, qmax, (mn, mx)


# ---------------------------------------------------------------------------
# The contractions.
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def full_fp32():
    """TF32 off for the products inside the block, and restored after:
    the reference's fp32 products (the sites' fp paths and the int8
    contractions' backward) are full fp32, while PyTorch lets cuDNN's fp32
    convolutions run in TF32 by default.  Nothing outside the block sees
    a change of either flag."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


# The rows of one batch index from which the backward's fp32 ``dx``
# products run one batch index at a time.  On the H100 cuBLAS picks
# split-K by shape: a row of a 49152-deep product took other bits in a
# 2048-row call than in a 4096-row one, and splitting only the products
# 4096 or more deep still moved two quant leaves of the data-parallel
# step.  Below this an index holds a GEMV's worth of rows (a classifier's
# one row a sample), where B calls would cost B launches for nothing
# measurable: such a product runs whole, and is not batch-invariant.
SPLIT_MIN_ROWS = 16
_BLOCKS = 1


@contextlib.contextmanager
def reassociate(blocks: int):
    """Within: the fp32 sums that :func:`in_blocks` carries (the
    backward's ``dx`` products' contraction, the decode's sums over the
    cache length) run in ``blocks`` blocks added in order, the model
    axis's association of those sums on one process.  A floor
    measurement reads the program's distance from itself under it;
    outside, every such sum is one call."""
    global _BLOCKS
    saved, _BLOCKS = _BLOCKS, blocks
    try:
        yield
    finally:
        _BLOCKS = saved


def in_blocks(part, size: int) -> torch.Tensor:
    """``part(0, size)``; within :func:`reassociate`, ``part(lo, n)`` over
    its blocks of ``range(size)`` (``sharding.split_range``), summed in
    order."""
    if _BLOCKS == 1:
        return part(0, size)
    acc = 0
    for i in range(_BLOCKS):
        acc = acc + part(*sharding.split_range(size, _BLOCKS, i))
    return acc


class _QMatmulInt(torch.autograd.Function):
    """``alpha * einsum(x_img - zp, w_img)`` exact in int32 (fused: the
    int8 matmul kernel; simulated: float64).  Backward is the reference's:
    fp32 products of the cotangent with the on-grid values ``xq``/``wq``,
    returned in their dtypes, under :func:`full_fp32`.  The cotangent of
    ``xq`` is computed one index of the output's ``batch_dim`` at a time
    where an index holds :data:`SPLIT_MIN_ROWS` rows or more: the card's
    GEMMs pick their algorithm (split-K over a long contraction) by
    shape, so a whole-batch product would make a row's cotangent depend
    on how many rows share the call, and a data-parallel rank's differ
    from the one-process step's.

    ``parallel`` (under a model group): ``"row"``, the contraction over
    this rank's K rows, whose int32 partials (``acc + corr``: the int32
    mode on the fused backend) are summed over the model group before
    the epilogue ``alpha * float(.)``, the one-process product bit for
    bit; ``"col"``, this rank's output columns, whose ``dx`` partial is
    summed over the model group in fp32 before its cast (Megatron's
    f).  ``seq_dim`` (the sequence-parallel residual,
    ``sharding.seq_rows``): a ``"row"`` product's partials are
    reduce-scattered onto this rank's rows of that dim of the output
    (still exact in int32; the cotangent is gathered back), and a
    ``"col"`` product's ``dx`` partial onto its rows of that dim of the
    input (in fp32, then placed among zeros: the input was gathered
    from the ranks' rows, whose gather keeps this rank's)."""

    @staticmethod
    def forward(ctx, xq, wq, x_img, w_img, x_zp, alpha, resolved, fused,
                batch_dim, parallel, seq_dim=None):
        mp = sharding.mp_shard() is not None
        row = parallel == "row" and mp
        seq = seq_dim if mp and parallel in ("row", "col") else None
        # (dim, whole rows) of the output (row) or the input (col)
        ctx.seq = None if seq is None else (seq, xq.shape[seq])

        def reduce(acc):
            if seq is None:
                return sharding.mp_sum_now(acc)
            ctx.seq = (seq, acc.shape[seq])
            return sharding.mp_scatter_now(acc, seq)
        if fused:
            ops = _ops()
            plan = ops.plan_einsum(resolved, x_img.ndim, w_img.ndim)
            if row:
                acc = reduce(ops.int8_matmul_int32(x_img, w_img, x_zp,
                                                   plan=plan))
                # a rank that holds none of the rows launches nothing
                y = acc.to(torch.float32) if acc.numel() == 0 else \
                    ops.int8_matmul_epilogue(acc, alpha)[0]
            else:
                y, _, _ = ops.int8_matmul_fp(x_img, w_img, x_zp, alpha,
                                             plan=plan)
        else:
            # int32 contraction, exact in float64 (integers far below 2**53).
            rx = x_img.to(torch.int32) - torch.round(x_zp).to(torch.int32)
            acc = torch.einsum(resolved, rx.to(torch.float64),
                               w_img.to(torch.float64))
            if row:
                acc = reduce(acc.to(torch.int64))
            y = alpha * acc.to(torch.float32)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(xq, wq)
            ctx.resolved, ctx.batch_dim = resolved, batch_dim
            ctx.col, ctx.row = parallel == "col" and mp, row
        return y

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        if ctx.row and ctx.seq is not None:
            g = sharding.mp_gather_now(g, *ctx.seq)
        lhs, y = ctx.resolved.split("->")
        xs, ws = lhs.split(",")
        gf = g.to(torch.float32)
        dx = dw = None
        with full_fp32():
            if ctx.needs_input_grad[0]:
                spec, wf = f"{y},{ws}->{xs}", wq.to(torch.float32)
                # the contraction's largest dim, for in_blocks
                k = max((c for c in y if c in ws and c not in xs),
                        key=lambda c: gf.shape[y.index(c)], default=None)

                def dx_of(gb):
                    if k is None:
                        return torch.einsum(spec, gb, wf)
                    kg, kw = y.index(k), ws.index(k)
                    return in_blocks(lambda lo, n: torch.einsum(
                        spec, gb.narrow(kg, lo, n), wf.narrow(kw, lo, n)),
                        gb.shape[kg])

                b = y[ctx.batch_dim]
                rows = 1
                for c, n in zip(y, gf.shape):
                    rows *= n if c in xs and c != b else 1
                # not a batch axis of the activation alone, or GEMV rows
                if b in ws or rows < SPLIT_MIN_ROWS:
                    dx = dx_of(gf)
                else:
                    d = y.index(b)
                    dx = torch.cat([dx_of(gf.narrow(d, i, 1))
                                    for i in range(gf.shape[d])],
                                   dim=xs.index(b))
                if ctx.col and ctx.seq is not None:
                    dx = sharding.mp_embed(
                        sharding.mp_scatter_now(dx, ctx.seq[0]), *ctx.seq)
                elif ctx.col:
                    dx = sharding.mp_sum_now(dx)
                dx = dx.to(xq.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.einsum(f"{xs},{y}->{ws}", xq.to(torch.float32),
                                  gf).to(wq.dtype)
        return dx, dw, None, None, None, None, None, None, None, None, None


PARALLEL = (None, "col", "row", "expert")


def qmatmul(policy, espec: str, xq: torch.Tensor, xqt: Optional[QTensor],
            wq: Optional[torch.Tensor], wqt: Optional[QTensor],
            out_dtype=None, batch_dim: int = 0,
            parallel: Optional[str] = None,
            seq_dim: Optional[int] = None) -> torch.Tensor:
    """Quantized-site contraction ``einsum(espec, xq, wq)``.

    With int8 images of both operands the contraction runs integer-exact
    (``alpha * int32``); otherwise it is the fp32 einsum of the on-grid
    values, for which ``wq=None`` means "dequantize ``wqt``".  ``wq`` (the
    on-grid weight values) is needed only when a gradient is recorded.
    ``parallel`` (see :class:`_QMatmulInt`; ``"expert"``: the rank's
    experts on a batch dim, nothing reduced) and ``seq_dim`` (the
    sequence-parallel residual's rows, see there) take effect under a
    model group only.  Profiles show the integer contraction as a
    ``qmatmul_int8_<backend> <spec>`` range (the MoE experts' as
    ``...egcd,edf->egcf`` and ``...egcf,efd->egcd``)."""
    if parallel not in PARALLEL:
        raise ValueError(f"parallel must be one of {PARALLEL}")
    out_dtype = out_dtype or xq.dtype
    if xqt is None or wqt is None or not int8_matmul_eligible(policy):
        if wq is None:
            wq = dequantize_qtensor(wqt).to(xq.dtype)
        with full_fp32():
            xf = xq.to(torch.float32)
            if parallel == "col":
                xf = sharding.mp_grad_sum(xf) if seq_dim is None else \
                    sharding.mp_grad_scatter(xf, seq_dim)
            y = torch.einsum(espec, xf, wq.to(torch.float32))
            if parallel == "row":
                y = sharding.mp_sum(y) if seq_dim is None else \
                    sharding.mp_scatter(y, seq_dim)
            return y.to(out_dtype)
    resolved = _ops().resolve_einsum_spec(espec, xq.ndim)
    alpha = (xqt.scale * wqt.scale).to(torch.float32)
    if wq is None and xq.requires_grad and torch.is_grad_enabled():
        wq = dequantize_qtensor(wqt).to(xq.dtype)     # frozen weight
    with torch.profiler.record_function(
            f"qmatmul_int8_{policy.backend} {resolved}"):
        y = _QMatmulInt.apply(xq, wq, xqt.q, wqt.q, xqt.zero_point, alpha,
                              resolved, policy.backend == FUSED, batch_dim,
                              parallel, seq_dim)
    return y.to(out_dtype)


def _conv_fp(x: torch.Tensor, w: torch.Tensor, plan) -> torch.Tensor:
    """``F.conv2d`` of an NHWC image and an HWIO kernel on ``plan``'s
    geometry, in ``x``'s dtype (the padding is explicit: XLA's "SAME"
    may pad one more row after than before).  The result is a contiguous
    NHWC tensor, laid out as ``int8_conv_fp``'s: a reduction over it in
    the backward pass (a bias's gradient) then sums in the same order on
    both backends."""
    (ph0, ph1), (pw0, pw1) = plan.pads
    xc = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=plan.stride,
                 dilation=plan.dilation, groups=plan.groups)
    return y.permute(0, 2, 3, 1).contiguous()


class _QConvInt(torch.autograd.Function):
    """``alpha * conv(x_img - zp, w_img)`` exact in int32 (fused: im2col
    onto the int8 matmul kernel, ``ops.int8_conv_fp``; simulated:
    ``F.conv2d`` in float64 of ``x_img - round(zp)`` by ``w_img``, exact
    because every partial sum is an integer far below 2**53, and zero
    padding there is the zero point's padding, as in the reference's int32
    XLA conv).  Both end in the same single fp32 multiply, so the outputs
    are bit-equal.

    Backward, shared by both backends, is the reference's: in the lowered
    (im2col) space the conv is the batched matmul ``[G, M, K] x [G, K,
    Fg]``, so ``dw`` is ``gmk,gmn->gkn`` and ``dx`` the order-pinned col2im
    (``ops.conv_unpatch``) of ``gmn,gkn->gmk``, fp32 products of the
    cotangent with the on-grid values ``xq``/``wq`` under
    :func:`full_fp32`."""

    @staticmethod
    def forward(ctx, xq, wq, x_img, w_img, x_zp, alpha, plan, fused):
        if fused:
            y, _, _ = _ops().int8_conv_fp(x_img, w_img, x_zp, alpha,
                                          plan=plan)
        else:
            rx = x_img.to(torch.float64) - torch.round(x_zp).to(torch.float64)
            acc = _conv_fp(rx, w_img.to(torch.float64), plan)
            # round(): a no-op on the exact sums, and a guard should a conv
            # algorithm of the device's library not be exact in float64.
            y = alpha * torch.round(acc).to(torch.float32)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(xq, wq)
            ctx.plan = plan
        return y

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        plan, ops = ctx.plan, _ops()
        dx = dw = None
        with full_fp32(), torch.profiler.record_function(
                "qconv_int8_bwd" + _depthwise_tag(plan)):
            gl = ops.conv_lower_output(g.to(torch.float32), plan)  # [G,M,Fg]
            if ctx.needs_input_grad[1]:
                xl = ops.conv_patches(xq.to(torch.float32), plan, 0.0)
                dw = ops.conv_unlower_weights(
                    torch.bmm(xl.transpose(1, 2), gl), plan).to(wq.dtype)
                del xl
            if ctx.needs_input_grad[0]:
                wl = ops.conv_lower_weights(wq.to(torch.float32), plan)
                dx = ops.conv_unpatch(torch.bmm(gl, wl.transpose(1, 2)),
                                      plan).to(xq.dtype)
        return dx, dw, None, None, None, None, None, None


def _depthwise_tag(plan) -> str:
    return "_depthwise" if plan.groups == plan.cin > 1 else ""


def qconv(policy, xq: torch.Tensor, xqt: Optional[QTensor],
          wq: Optional[torch.Tensor], wqt: Optional[QTensor], *,
          stride=1, padding="SAME", dilation=1, groups: int = 1,
          out_dtype=None) -> torch.Tensor:
    """Quantized-site convolution (NHWC x HWIO -> NHWC), the conv analogue
    of :func:`qmatmul`.

    With int8 images of both operands the contraction runs integer-exact
    on either backend (the fused backend lowers onto the batched int8
    matmul kernel — depthwise and grouped convs ride its batch
    dimension); otherwise it is the fp32 conv of the on-grid values (for
    example calibration's 16-bit grids, or the ``fp32`` policy), for which
    ``wq=None`` means "dequantize ``wqt``".  ``wq`` is needed only when a
    gradient is recorded.  Profiles show the site as a
    ``qconv_int8_<backend>`` range (``qconv_fp`` on the fp path; depthwise
    convs with a ``_depthwise`` suffix), as the reference's named scopes
    do."""
    out_dtype = out_dtype or xq.dtype
    plan = _ops().plan_conv(xq.shape, (wq if wq is not None else wqt.q).shape,
                            stride, padding, dilation, groups)
    if xqt is None or wqt is None or not int8_matmul_eligible(policy):
        if wq is None:
            wq = dequantize_qtensor(wqt)
        with full_fp32(), torch.profiler.record_function("qconv_fp"):
            return _conv_fp(xq.to(torch.float32), wq.to(torch.float32),
                            plan).to(out_dtype)
    alpha = (xqt.scale * wqt.scale).to(torch.float32)
    if wq is None and xq.requires_grad and torch.is_grad_enabled():
        wq = dequantize_qtensor(wqt).to(xq.dtype)     # frozen weight
    with torch.profiler.record_function(
            f"qconv_int8_{policy.backend}" + _depthwise_tag(plan)):
        y = _QConvInt.apply(xq, wq, xqt.q, wqt.q, xqt.zero_point, alpha,
                            plan, policy.backend == FUSED)
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# The attention core as one quant site.
# ---------------------------------------------------------------------------
KV_SPEC = quant.QuantSpec(bits=8, symmetric=True, stochastic=False)
P_SPEC = quant.QuantSpec(bits=8, symmetric=False, stochastic=False)


def qattention_eligible(policy) -> bool:
    """True iff the attention core can run as an int8 quant site (static
    activation ranges on an 8-bit grid)."""
    return bool(policy.enabled and policy.quantize_acts
                and policy.act_estimator.is_static
                and policy.act_spec.bits == 8)


def _pstats_vector(policy, stats6, p_lo, p_hi):
    """The probability-site stats vector of the policy's width from the
    kernel's partials reduction ``[mn, mx, clip, n, err, sig]``.  Unlike
    ``site_stats`` (a sampled prefix), these counters are exact
    full-tensor values: the kernel sees every probability on its tiles."""
    base = pack_stats(stats6[0], stats6[1])
    if not policy.telemetry.enabled:
        return base
    util = (stats6[1] - stats6[0]) / torch.clamp(p_hi - p_lo, min=1e-12)
    zero = torch.zeros_like(util)
    return torch.cat([base, torch.stack([stats6[2], stats6[3], stats6[4],
                                         stats6[5], util, zero, zero])])


class _QAttention(torch.autograd.Function):
    """The int8 attention core (fused: the CUDA kernel; simulated: the
    order-pinned plain version) with the reference's recompute-based
    backward, shared by both backends.  Inputs are the head-major on-grid
    q/k/v values (for the backward), their integer images, the registers
    and ``kv_len``; outputs ``(out, stats6)``, the statistics not
    differentiable.  ``kv_sum``: k and v are whole on every model rank
    while q holds the rank's heads or rows, so their cotangents, each
    rank's partial, are summed over the model group in fp32 before their
    cast.  ``q_start``: q holds the rows from there of ``sched``'s call
    (the sequence-parallel core)."""

    @staticmethod
    def forward(ctx, qh, kh, vh, q_img, k_img, v_img, regs, kvl, sched,
                fused, z_chunk, kv_sum, q_start):
        from repro_torch.kernels import int8_attention as mod
        args = (q_img, k_img, v_img, regs, kvl)
        kw = {"q_start": q_start} if q_start else {}
        if fused:
            out, ml, ps = _ops().int8_attention_fp(*args, sched=sched, **kw)
        else:
            out, ml, ps = mod.attention_core_reference(*args, sched=sched,
                                                       **kw)
        stats6 = torch.stack(mod.reduce_pstats(ps))
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(qh, kh, vh, q_img, k_img, v_img, regs, kvl,
                                  out, ml)
            ctx.sched, ctx.z_chunk, ctx.kv_sum = sched, z_chunk, kv_sum
            ctx.q_start = q_start
        ctx.mark_non_differentiable(stats6)
        return out, stats6

    @staticmethod
    def backward(ctx, g_out, _g_stats):
        from repro_torch.kernels import int8_attention as mod
        qh, kh, vh, *rest = ctx.saved_tensors
        kw = {"q_start": ctx.q_start} if ctx.q_start else {}
        dq, dk, dv = mod.attention_core_backward(
            qh, kh, vh, *rest, g_out.to(torch.float32), sched=ctx.sched,
            z_chunk=ctx.z_chunk, **kw)
        if ctx.kv_sum:
            dk, dv = sharding.mp_sum_now(dk), sharding.mp_sum_now(dv)
        return (dq.to(qh.dtype), dk.to(kh.dtype), dv.to(vh.dtype),
                None, None, None, None, None, None, None, None, None, None)


def qattention(policy, q, k, v, sites: dict, *, mode: str, window=None,
               prefix_len=None, kv_len=None, scale: float, step,
               model_dims=(None, None), q_start: int = 0,
               sq_total: Optional[int] = None):
    """Backend-dispatched int8 attention core.

    ``q [B, S, KV, G, hd]`` x ``k/v [B, Skv, KV, hd]`` -> ``(out [B, S, KV,
    G, hd], stats)`` with hindsight ranges for q, k, v and the softmax
    probabilities; ``sites`` is the ``{"q"/"k"/"v"/"p": {"act": leaf}}``
    core-site tree.  The block plan comes from
    :func:`repro_torch.kernels.tuning.attention_block`, exactly as in the
    reference, so both backends replay the reference's schedule.
    ``model_dims``: the dims of q and of k / v a model rank holds a slice
    of (None: whole); the p-site is always this rank's heads' or rows'.
    ``q_start`` / ``sq_total``: q is the rows ``[q_start, q_start + S)``
    of a core of ``sq_total`` query rows (the sequence-parallel rank's),
    planned and masked as that whole core."""
    from repro_torch.kernels import int8_attention as mod
    from repro_torch.kernels import tuning

    b, s, kvh, g, hd = q.shape
    skv = k.shape[1]
    cfg = policy.act_estimator
    dev = q.device
    q_dim, kv_dim = model_dims
    qh, q_st, q_qt = site_quantize(policy, q, sites["q"]["act"], step,
                                   name="attn_q", model_dim=q_dim)
    kh, k_st, k_qt = site_quantize(policy, k, sites["k"]["act"], step,
                                   cfg=cfg, spec=KV_SPEC, name="attn_k",
                                   model_dim=kv_dim)
    vh, v_st, v_qt = site_quantize(policy, v, sites["v"]["act"], step,
                                   cfg=cfg, spec=KV_SPEC, name="attn_v",
                                   model_dim=kv_dim)
    p_lo, p_hi = estimators.static_ranges(cfg, sites["p"]["act"])
    p_lo, p_hi = p_lo.to(torch.float32), p_hi.to(torch.float32)
    scale_p, zp_p = quant.scale_zero_point(p_lo, p_hi, P_SPEC)

    alpha_qk = torch.tensor(scale, dtype=torch.float32, device=dev) \
        * q_qt.scale * k_qt.scale
    alpha_pv = scale_p * v_qt.scale
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    regs = torch.stack([q_qt.zero_point, alpha_qk, scale_p, zp_p, alpha_pv,
                        p_lo, p_hi, zero]).to(torch.float32)
    kvl = torch.tensor([skv if kv_len is None else int(kv_len)],
                       dtype=torch.int32, device=dev)

    sq_total = s if sq_total is None else int(sq_total)
    bq, bkv = tuning.attention_block(sq_total, skv, hd)
    # a rank's heads (one of a padded share's, or none: then no launch)
    sched = mod.make_schedule(
        sq=sq_total, skv=skv, hd=hd, bq=bq, bkv=bkv, groups=max(g, 1),
        mode=mode,
        window=int(window or 0), prefix_len=int(prefix_len or 0),
        sm_scale=float(scale))

    def qflat(t):
        return t.permute(0, 2, 3, 1, 4).reshape(b * kvh * g, s, hd)

    def kvflat(t):
        return t.permute(0, 2, 1, 3).reshape(b * kvh, skv, hd)

    out3, stats6 = _QAttention.apply(
        qflat(qh), kvflat(kh), kvflat(vh), qflat(q_qt.q), kvflat(k_qt.q),
        kvflat(v_qt.q), regs, kvl, sched, policy.backend == FUSED, kvh,
        q_dim is not None and kv_dim is None
        and sharding.mp_shard() is not None, int(q_start))
    out = out3.reshape(b, kvh, g, s, hd).permute(0, 3, 1, 2, 4).to(q.dtype)
    p_st = _pstats_vector(policy, stats6, p_lo, p_hi) if q.numel() else \
        _unvisited(policy, dev)
    stats = {"q": {"act": q_st}, "k": {"act": k_st}, "v": {"act": v_st},
             "p": {"act": p_st}}
    return out, stats
