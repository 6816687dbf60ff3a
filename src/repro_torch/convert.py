"""Layout conversion between the JAX package's trees and the port's.

The JAX package scans its stacks: per-layer params, quant state, stats
and caches live under ``decoder/blocks/b<j>`` with a leading
``[repeats, ...]`` axis (plus an unrolled ``decoder/tail/t<j>``), and
the enc-dec family's encoder likewise under ``encoder/`` (its pattern
``cfg.enc_pattern``, ``cfg.enc_layers`` deep).  The port keeps one entry
per layer under ``decoder/layers`` and ``encoder/layers``; every other
subtree (``enc_in``, ``enc_norm``, ``patch_proj``, the head) is carried
across as it is.  These helpers
take the JAX trees as nested dicts of numpy arrays (no JAX import) and
return the port's trees of tensors, and back — so tests can feed the
reference's parameters to the port and compare stats, quant states and
caches site by site, and start a training run from the reference's train
state.  bf16 arrays round-trip exactly (to float32 on the way back).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.param_tree import ParamTree


def _split(pattern, n_layers: int):
    u = len(pattern)
    repeats = n_layers // u
    return u, repeats, n_layers - repeats * u


def _stacks(cfg) -> dict:
    """The scanned subtrees: name -> (pattern, depth)."""
    out = {"decoder": (cfg.pattern, cfg.n_layers)}
    if cfg.family == "encdec":
        out["encoder"] = (cfg.enc_pattern, cfg.enc_layers)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _index(tree, r: int):
    return _map(lambda a: a[r], tree)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)                       # a writable copy torch can own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t) -> np.ndarray:
    """A copy: the training step updates parameters in place."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()


def unstack(dec: dict, pattern, n_layers: int) -> dict:
    """JAX ``{"blocks": ..., "tail": ...}`` -> ``{"layers": [...]}``."""
    u, repeats, n_tail = _split(pattern, n_layers)
    layers = []
    for idx in range(n_layers):
        r, j = divmod(idx, u)
        if r < repeats:
            layers.append(_index(dec["blocks"][f"b{j}"], r))
        else:
            layers.append(dec["tail"][f"t{idx - repeats * u}"])
    return {"layers": layers}


def stack(dec: dict, pattern, n_layers: int) -> dict:
    """Port ``{"layers": [...]}`` -> JAX ``{"blocks": ..., "tail": ...}``."""
    u, repeats, n_tail = _split(pattern, n_layers)
    layers = dec["layers"]
    blocks = {} if repeats == 0 else {
        f"b{j}": _stack([layers[r * u + j] for r in range(repeats)])
        for j in range(u)}
    tail = {f"t{j}": layers[repeats * u + j] for j in range(n_tail)}
    return {"blocks": blocks, "tail": tail}


def from_jax_layout(tree: dict, cfg, device=None) -> dict:
    """A JAX params / quant-state / stats / cache tree (numpy leaves) as
    the port's tree of tensors on ``device`` (the card unless ``"cpu"``)."""
    device = resolve_device(device)
    stacks = _stacks(cfg)
    out = {}
    for k, v in tree.items():
        if k in stacks:
            v = unstack(v, *stacks[k])
        out[k] = _map(lambda a: _to_tensor(a, device), v)
    return out


def to_jax_layout(tree: dict, cfg) -> dict:
    """The port's tree as the JAX layout, with numpy leaves."""
    stacks = _stacks(cfg)
    out = {}
    for k, v in tree.items():
        v = _map(_to_numpy, v)
        if k in stacks:
            v = stack(v, *stacks[k])
        out[k] = v
    return out


def params_from_jax(tree: dict, cfg, device=None) -> ParamTree:
    """The JAX package's ``init_params`` tree as the port's parameters."""
    return ParamTree(from_jax_layout(tree, cfg, device))


def params_to_jax(params, cfg, named=None) -> dict:
    """The port's ``ParamTree`` as the JAX params layout (numpy leaves).
    With ``named`` (a dict keyed like ``named_parameters()``, e.g. the
    gradients of a step) its tensors take the parameters' places."""
    def plain(mod, prefix):
        if isinstance(mod, ParamTree):
            return {name: plain(mod[name], f"{prefix}{name}.")
                    for name in mod._names}
        if isinstance(mod, torch.nn.ModuleList):
            return [plain(m, f"{prefix}{i}.") for i, m in enumerate(mod)]
        return mod if named is None else named[prefix[:-1]]
    return to_jax_layout(plain(params, ""), cfg)


def train_state_from_jax(state: dict, cfg, optimizer, device=None) -> dict:
    """A JAX train state's ``params`` and ``quant`` trees (numpy leaves) as
    the port's train state at the same ``step``, with a fresh optimizer
    state from ``optimizer``."""
    from repro_torch.runtime import steps
    params = params_from_jax(state["params"], cfg, device)
    quant = from_jax_layout(state["quant"], cfg, device)
    return steps.train_state(params, quant, optimizer,
                             step=int(state.get("step", 0)))


def cnn_state_from_jax(params: dict, bn: dict, quant: dict, device=None):
    """The JAX CNN trees (``repro.cnn.init``'s params and BN state, and
    its quant sites; numpy leaves) as the port's ``(ParamTree, bn, quant)``
    on ``device``.  The CNN trees have no stacked layers, and NHWC/HWIO
    layouts are kept, so only the leaves change type."""
    device = resolve_device(device)

    def conv(tree):
        return _map(lambda a: _to_tensor(a, device), tree)
    return ParamTree(conv(params)), conv(bn), conv(quant)
