"""Optimizers (port of ``repro/optim/optimizers.py``) as plain functions on
dicts of tensors keyed by parameter name.

The reference is pytree-functional: ``update`` returns the updates and a
new state, and ``apply_updates`` adds them to the parameters.  At full
width a second copy of the parameters (12.7 GB for starcoder2-3b in fp32)
does not fit beside the gradients and the AdamW moments, so the port's
``update`` works one tensor at a time: it updates the moments in place and
applies each parameter's update in place at once (under
``torch.no_grad``), and returns the optimizer state.  The arithmetic is the
reference's, op for op (``mhat / (sqrt(vhat) + eps) + wd * p``, the bias
correction from ``count``), so only the order of the fp32 reductions inside
``global_norm`` differs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], dict]
    update: Callable[..., dict]    # (grads, state, params, lr) -> state


def _apply(p: torch.Tensor, u: torch.Tensor) -> None:
    p.add_(u.to(p.dtype))


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """``params[k] += updates[k]`` in place; returns ``params``."""
    for k, p in params.items():
        _apply(p, updates[k])
    return params


@torch.no_grad()
def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(F32)))
                          for t in tree.values()))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns ``(grads, norm before clipping)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


def _pow_f32(base: float, exp: int) -> float:
    """``base ** exp`` evaluated in fp32, as the reference's traced pow."""
    return float(torch.tensor(base, dtype=F32)
                 ** torch.tensor(float(exp), dtype=F32))


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0,
         nesterov: bool = False) -> Optimizer:
    """SGD + momentum, fp32 update (the paper's optimizer)."""
    def init(params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, lr):
        lr = float(lr)
        for k, p in params.items():
            g = grads[k].to(F32)
            if weight_decay:
                g = g + weight_decay * p.to(F32)
            m = state["m"][k]
            m.mul_(momentum).add_(g)
            step = (g + momentum * m) if nesterov else m
            _apply(p, step * -lr)
        return state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        lr = float(lr)
        c = state["count"] + 1
        bc1 = float(1.0 - torch.tensor(_pow_f32(b1, c), dtype=F32))
        bc2 = float(1.0 - torch.tensor(_pow_f32(b2, c), dtype=F32))
        for k, p in params.items():
            g = grads[k].to(F32)
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps) + \
                weight_decay * p.to(F32)
            _apply(p, step * -lr)
        state["count"] = c
        return state

    return Optimizer(init, update)
