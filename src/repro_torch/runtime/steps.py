"""Step builders: training with gradient accumulation, prefill, decode
(port of ``repro/runtime/steps.py``).

Train state: ``{"params": ParamTree, "opt": optimizer state, "quant":
quant-state tree, "step": int}``.  The parameters and optimizer moments
are updated in place; the quant tree is replaced each step.

Quant-range plumbing per step (the paper's update loop):

  1. every quantizer uses the PRE-STEP state (in-hindsight static ranges);
  2. each microbatch's forward emits activation-site statistics, and its
     backward emits gradient-site statistics as the gradients of the quant
     state's grad leaves (the cotangent channel): each microbatch reads
     them with ``torch.autograd.grad`` over fresh copies of those leaves
     that require grad — never through ``.grad``, which would sum them;
  3. microbatch statistics combine with (min, max, visited-or), parameter
     gradients average;
  4. ONE estimator update per optimizer step (eq. 2-3).

The ``compress`` hook (``runtime.compress.Compressor``: the int8
in-hindsight gradient reduction) runs where the reference's does, after
accumulation and before clipping.

Data parallelism (``group``, a ``torch.distributed`` process group): the
counterpart of the reference's ``jax.jit(train_step, in_shardings=...)``
over the ``data`` axis, one controller per rank.  Every rank is given the
global batch and takes its dim-0 shard of each microbatch
(``sharding.batch_pspecs``'s rule: a batch that does not divide is
replicated, and each rank then runs the single-device step).  Under
``sharding.data_parallel`` the step computes what the global program
computes: the loss is the mean over the global batch (each rank divides
its token sum by the global count, so every cotangent is the
single-device one), a site whose range reads the current tensor (the
first batch, a dynamic estimator) sees the global (min, max), a gradient
site's stochastic-rounding noise is this rank's rows of the global
site's noise (``backend.shard_noise``: the global tensor drawn, N times
the draw), and the MoE load-balance and z losses take global means.
Parameter gradients are summed over the ranks (fp32 ``all_reduce``s in
place or in 25 MB buckets, or ``compress`` on each rank's per-replica
gradient), the quant statistics combine as microbatches do (one
``all_reduce`` MAX of ``(-min, max, visited)`` and the max-combined
telemetry slots; at width 10 one SUM of the counters), the metrics are
summed.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

import torch.distributed as dist

from repro_torch.core import backend, estimators, qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import INITED, QMAX, QMIN, tree_leaves, \
    tree_map, tree_map_with_path
from repro_torch.models import model
from repro_torch.optim import clip_by_global_norm
from repro_torch.telemetry import config as tc

from . import sharding


def train_state(params, quant, optimizer, step: int = 0) -> dict:
    """A train state around existing parameters (which start requiring
    grad) and quant state, with a fresh optimizer state."""
    for p in params.parameters():
        p.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(named_params(params)),
            "quant": quant, "step": int(step)}


def init_train_state(cfg, optimizer, policy: Optional[QuantPolicy] = None,
                     *, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed`` and a fresh quant state on
    ``device`` (the card unless ``"cpu"`` is asked for); ``policy`` only
    matters for its telemetry flag, which widens every quant leaf from 3
    to 10 floats."""
    params = model.init_params(cfg, seed=seed, device=device)
    quant = model.init_quant_state(cfg, policy, device=params.embed.device)
    return train_state(params, quant, optimizer)


def named_params(params) -> dict:
    """``{dotted name: tensor}`` in registration order: the flat view the
    optimizer and the gradients use."""
    return dict(params.named_parameters())


def _is_grad_leaf(path) -> bool:
    return bool(path) and path[-1] == "grad"


def grads_and_stats(loss_of_quant, params, quant):
    """Gradients of the parameters and gradient-site statistics of one
    forward + backward.  ``loss_of_quant(quant_in) -> (loss, fwd_stats,
    aux)`` runs the forward on ``quant_in``, a copy of ``quant`` whose grad
    leaves are fresh tensors that require grad; their gradients are the
    cotangent channel's statistics.  Returns ``(loss, grads, stats, aux)``:
    grads as a dict like :func:`named_params`, stats shaped like ``quant``
    (the forward statistics merged with the cotangent channel's)."""
    leaves = {}

    def track(path, leaf):
        if _is_grad_leaf(path):
            leaf = leaves[path] = leaf.detach().requires_grad_(True)
        return leaf

    loss, fwd_stats, aux = loss_of_quant(tree_map_with_path(track, quant))
    named = named_params(params)
    inputs = list(named.values()) + list(leaves.values())
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    with torch.no_grad():
        pg = {k: torch.zeros_like(p) if g is None else g
              for (k, p), g in zip(named.items(), grads)}
        cot = dict(zip(leaves, grads[len(named):]))
        cot_stats = tree_map_with_path(
            lambda path, leaf: cot.get(path) if cot.get(path) is not None
            else torch.zeros_like(leaf), quant)
        stats = qlinear.merge_stats(tree_map(torch.Tensor.detach, fwd_stats),
                                    cot_stats)
    return loss.detach(), pg, stats, aux


def forward_backward(cfg, policy, params, quant, mb, step: int, midx: int):
    """One microbatch's forward + backward (site seed ``step * 262144 +
    midx * 8192``).  Returns ``(loss, grads, stats, metrics)`` as
    :func:`grads_and_stats` does."""
    seed = step * 262144 + midx * 8192

    def loss_of_quant(quant_in):
        loss, (fwd_stats, met) = model.loss_fn(params, quant_in, mb, cfg,
                                               policy, seed, step)
        return loss, fwd_stats, met

    loss, pg, stats, met = grads_and_stats(loss_of_quant, params, quant)
    return loss, pg, stats, {k: v.detach() for k, v in met.items()}


def _flat_all_reduce(tensors: list, op, group) -> list:
    """One ``all_reduce`` of the tensors packed into one fp32 buffer;
    returns them reduced, in their dtypes and shapes."""
    buf = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(buf, op=op, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


BUCKET_BYTES = 25 << 20     # the gradient all_reduce's bucket size


def _all_reduce_grads(grads: dict, group) -> dict:
    """The parameter gradients summed over the ranks: a contiguous fp32
    gradient of :data:`BUCKET_BYTES` or more in place, the others packed
    into fp32 buckets of about that size, so the reduction holds at most
    one bucket beside the gradients."""
    out, bucket, size = dict(grads), [], 0

    def flush():
        keys = list(bucket)
        bucket.clear()
        out.update(zip(keys, _flat_all_reduce([grads[k] for k in keys],
                                              dist.ReduceOp.SUM, group)))

    for k, g in grads.items():
        if g.dtype == torch.float32 and g.is_contiguous() and \
                g.numel() * 4 >= BUCKET_BYTES:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
            continue
        bucket.append(k)
        size += g.numel() * 4
        if size >= BUCKET_BYTES:
            flush()
            size = 0
    if bucket:
        flush()
    return out


def dp_combine_stats(stats, group):
    """Every rank's statistics tree combined as :func:`qlinear.
    combine_stats` combines microbatches: min of mins, max of maxes,
    visited-or (one ``all_reduce`` MAX of ``(-min, max, visited)`` with
    the max-combined telemetry slots), and at width 10 the counters summed
    (one SUM)."""
    leaves = tree_leaves(stats)
    big = 3.4e38
    packed = []
    for st in leaves:
        v = st[INITED] > 0.5
        row = [torch.where(v, -st[QMIN], -big), torch.where(v, st[QMAX], -big),
               st[INITED]]
        packed.append(torch.cat([torch.stack(row), st[tc.T_UTIL:]])
                      if st.shape[-1] > 3 else torch.stack(row))
    maxed = _flat_all_reduce(packed, dist.ReduceOp.MAX, group)
    summed = _flat_all_reduce([st[tc.T_CLIP:tc.T_UTIL] for st in leaves
                               if st.shape[-1] > 3], dist.ReduceOp.SUM,
                              group) if leaves[0].shape[-1] > 3 else []
    out = []
    for i, m in enumerate(maxed):
        v = m[2] > 0.5
        base = torch.stack([torch.where(v, -m[0], 0.0),
                            torch.where(v, m[1], 0.0), m[2]])
        out.append(torch.cat([base, summed[i], m[3:]]) if summed else base)
    it = iter(out)
    return tree_map(lambda _: next(it), stats)


def make_train_step(cfg, policy: QuantPolicy, optimizer, lr_schedule: Callable,
                    *, grad_accum: int = 1,
                    clip_norm: Optional[float] = 1.0, compress=None,
                    group=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is ``{"tokens", "labels", "mask"}`` on the parameters'
    device; with ``grad_accum > 1`` its batch axis splits into that many
    microbatches.  The step is backend-agnostic: ``policy.backend`` picks
    simulated fake-quant or the kernels at every site.  ``compress(grads,
    stats) -> (grads, stats)`` replaces the gradient reduction (it takes
    per-replica gradients and returns their mean); ``group`` makes the
    step data-parallel over that process group (module docstring)."""
    backend.validate(policy)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    world = 1 if group is None else dist.get_world_size(group)
    if world > 1 and estimators.DSGC in (policy.act_estimator.kind,
                                         policy.grad_estimator.kind):
        raise ValueError("the dsgc estimator searches the whole tensor; "
                         "the data-parallel step does not take it")

    def train_step(state: dict, batch: dict):
        params, quant, step = state["params"], state["quant"], state["step"]
        n = next(iter(batch.values())).shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} does not split into "
                             f"{grad_accum} microbatches")
        size = n // grad_accum
        # the batch_pspecs rule: a microbatch the ranks do not divide is
        # replicated, and every rank runs the single-device step
        sharded = world > 1 and size % world == 0
        dp = sharding.data_parallel(group) if sharded \
            else contextlib.nullcontext()
        with dp:
            for midx in range(grad_accum):
                mb = batch if grad_accum == 1 else \
                    {k: v[midx * size:(midx + 1) * size]
                     for k, v in batch.items()}
                if sharded:
                    mb = {k: sharding.shard_rows(v) for k, v in mb.items()}
                out = forward_backward(cfg, policy, params, quant, mb, step,
                                       midx)
                if midx == 0:
                    loss, grads, stats, met = out
                    continue
                with torch.no_grad():
                    for k, g in out[1].items():
                        grads[k].add_(g)
                    stats = tree_map(qlinear.combine_stats, stats, out[2])
                    loss = loss + out[0]
                    met = {k: met[k] + out[3][k] for k in met}
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            with torch.no_grad():
                for g in grads.values():
                    g.mul_(inv)
            loss = loss * inv
            met = {k: v * inv for k, v in met.items()}

        if sharded:
            with torch.no_grad():
                # each rank's gradient is its share of the global one
                if compress is None:
                    grads = _all_reduce_grads(grads, group)
                else:   # per-replica gradients, whose mean the hook takes
                    grads = {k: g * world for k, g in grads.items()}
                stats = dp_combine_stats(stats, group)
                keys = list(met)
                vals = _flat_all_reduce([loss] + [met[k] for k in keys],
                                        dist.ReduceOp.SUM, group)
                loss, met = vals[0], dict(zip(keys, vals[1:]))
        if compress is not None:
            grads, stats = compress(grads, stats)

        metrics = dict(met)
        if clip_norm is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads,
                                                              clip_norm)
        lr = lr_schedule(step)
        opt = optimizer.update(grads, state["opt"], named_params(params), lr)
        del grads
        with torch.no_grad():
            new_quant = qlinear.update_quant_state(policy, quant, stats)
        metrics["loss"] = loss
        metrics["lr"] = lr
        return {"params": params, "opt": opt, "quant": new_quant,
                "step": step + 1}, metrics

    return train_step


def make_prefill_step(cfg, policy: QuantPolicy,
                      cache_len: Optional[int] = None) -> Callable:
    """``prefill_step(params, quant, batch) -> (last logits, caches)``."""
    def prefill_step(params, quant, batch):
        return model.prefill(params, quant, batch, cfg, policy,
                             cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg, policy: QuantPolicy) -> Callable:
    """``decode_step(params, quant, batch, caches) -> (logits, caches)``
    for ``batch = {"token": [B, 1], "pos": [B]}``; the caches are updated
    in place."""
    def decode_step(params, quant, batch, caches):
        return model.decode_step(params, quant, batch["token"], batch["pos"],
                                 caches, cfg, policy)
    return decode_step
