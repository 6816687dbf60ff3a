"""Quantization-range state (port of ``repro/core/state.py``).

Every quantization site owns a flat fp32 vector
``leaf = [qmin, qmax, initialized]``.  In the port the quant state is a
plain nested dict of such tensors, one entry per layer (the reference
stacks scanned layers into ``[repeats, 3]`` leaves; see
``repro_torch.convert`` for the mapping).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

QMIN, QMAX, INITED = 0, 1, 2

Tree = Any


def init_range_state(width: int = 3, device=None) -> torch.Tensor:
    """A fresh, uninitialized site state."""
    return torch.zeros((width,), dtype=torch.float32, device=device)


def make_range_state(qmin: float, qmax: float, device=None) -> torch.Tensor:
    return torch.tensor([qmin, qmax, 1.0], dtype=torch.float32, device=device)


def pack_stats(obs_min: torch.Tensor, obs_max: torch.Tensor) -> torch.Tensor:
    """Observed statistics in the leaf layout; slot 2 = "visited"."""
    mn = obs_min.to(torch.float32)
    return torch.stack([mn, obs_max.to(torch.float32), torch.ones_like(mn)])


# ---------------------------------------------------------------------------
# Nested-container helpers (dicts and lists of tensors) — the port's
# stand-in for jax.tree_util on the quant-state / stats / cache trees.
# ---------------------------------------------------------------------------
def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Tree, *rest: Tree,
                       path: tuple = ()) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_leaves(tree: Tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out



def inited_count(tree: Tree) -> int:
    """How many leaves of a quant-state tree hold a range (one host
    read)."""
    return int(torch.stack([leaf[INITED] for leaf in tree_leaves(tree)])
               .gt(0.5).sum())
