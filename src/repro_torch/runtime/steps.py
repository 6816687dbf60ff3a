"""The training step with gradient accumulation (port of
``repro/runtime/steps.py``: ``init_train_state`` and ``make_train_step``).

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

The reference's ``compress`` hook (the int8 data-parallel gradient
reduction) comes with the distribution slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import backend, qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import tree_map, tree_map_with_path
from repro_torch.models import model
from repro_torch.optim import clip_by_global_norm


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


def make_train_step(cfg, policy: QuantPolicy, optimizer, lr_schedule: Callable,
                    *, grad_accum: int = 1,
                    clip_norm: Optional[float] = 1.0) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is ``{"tokens", "labels", "mask"}`` on the parameters'
    device; with ``grad_accum > 1`` its batch axis splits into that many
    microbatches.  The step is backend-agnostic: ``policy.backend`` picks
    simulated fake-quant or the kernels at every site."""
    backend.validate(policy)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(state: dict, batch: dict):
        params, quant, step = state["params"], state["quant"], state["step"]
        if grad_accum == 1:
            loss, grads, stats, met = forward_backward(
                cfg, policy, params, quant, batch, step, 0)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"batch {n} does not split into "
                                 f"{grad_accum} microbatches")
            size = n // grad_accum
            for midx in range(grad_accum):
                mb = {k: v[midx * size:(midx + 1) * size]
                      for k, v in batch.items()}
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
            inv = 1.0 / grad_accum
            with torch.no_grad():
                for g in grads.values():
                    g.mul_(inv)
            loss = loss * inv
            met = {k: v * inv for k, v in met.items()}

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
