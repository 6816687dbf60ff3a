"""In-hindsight int8 compression of the data-parallel gradient all-reduce
(port of ``repro/runtime/compress.py``).

The paper's property, that the quantization range of step t is known
before step t starts and identically on every rank, carries to the
collective layer: every rank quantizes its local gradient with the same
pre-agreed in-hindsight range (no range round-trip), the int8 images are
summed exactly as int32 (``all_reduce`` SUM), the sum dequantizes as
``qsum * scale / n``, and the statistics feed the estimator update of the
next step (eq. 2-3).  Stochastic rounding differs per rank, so the result
is an unbiased estimate of the fp32 mean.

The quantize is the ``stochastic_quantize`` kernel in its operand form
with the symmetric spec and zero point 0: ``floor(g / scale + 0 + u)``,
clipped to [-128, 127], is the reference's ``floor(g / scale + noise)``
bit for bit, and the kernel's min/max partials are the local (min, max)
the reference reads in a second pass (``quant.tensor_minmax``): the
paper's single pass, at the collective layer.  The statistics of every
leaf travel in one fp32 ``all_reduce`` MAX of ``(-min, max)`` pairs (exact
in any order) where the reference runs a ``pmin`` and a ``pmax`` per leaf.

``torch.distributed`` has one controller per rank, so ``reduce_fn`` takes
each rank's LOCAL gradient dict (keyed like the parameters), where the
reference's ``shard_map`` takes the ``[n_dp, ...]`` stack.  Step 0: a leaf
without a range takes the pmax of |g| over the ranks (the same scale on
every rank, or the integer sum would mix grids); the reference computes
that pmax on every call and drops it with ``where``, the port runs the
collective only while a leaf is uninitialized, reading the leaves'
``inited`` flags once per call.  The values are the same.

Noise: leaf ``i`` on rank ``r`` draws from :func:`leaf_noise` (a seeded
generator on the leaf's device), the counterpart of the reference's
``fold_in(fold_in(PRNGKey(seed), i), axis_index)`` key; the tests patch
it with the reference's noise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import estimators
from repro_torch.core.quant import QuantSpec
from repro_torch.core.state import INITED, QMAX, QMIN, pack_stats

GRAD_SPEC = QuantSpec(bits=8, symmetric=True, stochastic=True)


def init_compress_state(grads_or_params: dict) -> dict:
    """One ``(qmin, qmax, inited)`` leaf per gradient leaf."""
    return {k: torch.zeros((3,), dtype=torch.float32, device=t.device)
            for k, t in grads_or_params.items()}


def leaf_noise(seed: int, index: int, rank: int, shape, device
               ) -> torch.Tensor:
    """``u ~ U[0, 1)`` of gradient leaf ``index`` on ``rank``."""
    mixed = ((int(seed) & 0xFFFFFFFF) * 0x9E3779B9 + index * 0x85EBCA6B
             + rank * 0xC2B2AE35) & 0xFFFFFFFFFFFF
    gen = torch.Generator(device=device).manual_seed(mixed)
    return torch.rand(tuple(shape), generator=gen, device=device,
                      dtype=torch.float32)


def _quantize_leaf(g: torch.Tensor, scale: torch.Tensor,
                   noise: torch.Tensor):
    """int8 image of ``g`` on the symmetric grid of ``scale`` with
    stochastic rounding, and ``g``'s (min, max), in one pass."""
    from repro_torch.kernels import ops
    qp = torch.stack([scale, torch.zeros_like(scale)])
    return ops.stochastic_quantize_registers(g, qp, noise, spec=GRAD_SPEC)


def _world(group) -> tuple:
    return dist.get_rank(group), dist.get_world_size(group)


def compressed_all_reduce_tree(grads: dict, state: dict, seed: int,
                               group=None) -> tuple:
    """int8-quantize -> all_reduce(int32) -> dequantize / N over ``group``
    (the counterpart of the reference's ``compressed_psum_tree``).
    Returns ``(mean_grads, stats)``: the stats are the (min, max) over the
    ranks of the LOCAL gradients (what is quantized next step)."""
    rank, n = _world(group)
    keys = list(grads)
    inited = torch.stack([state[k][INITED] for k in keys]).gt(0.5).tolist()
    amax = {k: torch.maximum(state[k][QMIN].abs(), state[k][QMAX].abs())
            for k, ini in zip(keys, inited) if ini}
    fresh = [k for k, ini in zip(keys, inited) if not ini]
    if fresh:
        obs = torch.stack([grads[k].to(torch.float32).abs().max()
                           for k in fresh])
        dist.all_reduce(obs, op=dist.ReduceOp.MAX, group=group)
        amax.update(zip(fresh, obs.unbind()))
    scales, images, ranges = {}, [], []
    for i, k in enumerate(keys):
        g = grads[k]
        scales[k] = torch.clamp(amax[k] / 127.0, min=1e-12)
        noise = leaf_noise(seed, i, rank, g.shape, g.device)
        q, mn, mx = _quantize_leaf(g.to(torch.float32), scales[k], noise)
        images.append(q.reshape(-1).to(torch.int32))
        ranges.append(torch.stack([-mn, mx]))
    qsum = torch.cat(images)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)   # exact
    ranges = torch.stack(ranges)
    dist.all_reduce(ranges, op=dist.ReduceOp.MAX, group=group)
    out, stats, at = {}, {}, 0
    for i, k in enumerate(keys):
        g = grads[k]
        qs = qsum[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
        out[k] = (qs.to(torch.float32) * scales[k] / n).to(g.dtype)
        stats[k] = pack_stats(-ranges[i, 0], ranges[i, 1])
    return out, stats


def emulate_all_reduce_tree(rank_grads: list, state: dict, seed: int
                            ) -> tuple:
    """The collective in one process, on the plain quantizer: every rank's
    gradient dict (``rank_grads[r]``) quantized with its own noise on the
    shared scale, the int32 images summed, ``* scale / n``; the statistics
    the (min, max) over the ranks.  What :func:`compressed_all_reduce_tree`
    must return on every rank."""
    from repro_torch.kernels.stochastic_quantize import \
        stochastic_quantize_plain
    n, out, stats = len(rank_grads), {}, {}
    for i, k in enumerate(rank_grads[0]):
        gs = [rg[k].to(torch.float32) for rg in rank_grads]
        leaf = state[k]
        if bool(leaf[INITED] > 0.5):
            amax = torch.maximum(leaf[QMIN].abs(), leaf[QMAX].abs())
        else:
            amax = torch.stack([g.abs().max() for g in gs]).max()
        scale = torch.clamp(amax / 127.0, min=1e-12)
        qp = torch.stack([scale, torch.zeros_like(scale)])
        qsum = sum(stochastic_quantize_plain(
            g, qp, leaf_noise(seed, i, r, g.shape, g.device),
            GRAD_SPEC)[0].to(torch.int32) for r, g in enumerate(gs))
        out[k] = (qsum.to(torch.float32) * scale / n).to(rank_grads[0][k].dtype)
        stats[k] = pack_stats(torch.stack([g.min() for g in gs]).min(),
                              torch.stack([g.max() for g in gs]).max())
    return out, stats


def make_compressor(group=None, momentum: float = 0.9):
    """Returns ``(reduce_fn, update_fn, init_state_fn)``.

    ``reduce_fn(grads, state, seed)`` takes this rank's local gradient
    dict and returns ``(mean_grads, stats)``, the mean over ``group``'s
    ranks through the int8 in-hindsight collective; ``update_fn(state,
    stats)`` is the hindsight estimator's update."""
    cfg = estimators.EstimatorConfig(kind=estimators.HINDSIGHT,
                                     momentum=momentum)

    def reduce_fn(grads, state, seed):
        return compressed_all_reduce_tree(grads, state, seed, group)

    def update_fn(state, stats):
        return {k: estimators.update(cfg, state[k], stats[k])
                for k in state}

    return reduce_fn, update_fn, init_compress_state


class Compressor:
    """The train step's ``compress`` hook, ``(grads, stats) -> (grads,
    stats)``: each call reduces this rank's per-replica gradients (the
    mean over the ranks) with seed ``seed + calls`` and folds the
    collective's statistics into its own range state."""

    def __init__(self, group=None, momentum: float = 0.9, seed: int = 0):
        self.group = group
        self.reduce, self.update, self.init = make_compressor(group,
                                                              momentum)
        self.state: Optional[dict] = None
        self.seed, self.calls = int(seed), 0

    def __call__(self, grads: dict, stats):
        if self.state is None:
            self.state = self.init(grads)
        out, cstats = self.reduce(grads, self.state, self.seed + self.calls)
        self.state = self.update(self.state, cstats)
        self.calls += 1
        return out, stats
