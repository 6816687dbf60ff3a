"""Model parameters as an ``nn.Module`` tree with dict-style access.

The reference keeps parameters in a pytree of nested dicts; the port
keeps the same nesting as a module tree — tensors become (frozen)
``nn.Parameter``s, dicts ``ParamTree``s, lists ``nn.ModuleList``s — so
``params["decoder"]["layers"][3]["attn"]["wq"]`` reads as in the
reference while ``.to()``, ``.parameters()`` and ``state_dict()`` work.
"""
from __future__ import annotations

import torch
from torch import nn


class ParamTree(nn.Module):
    def __init__(self, tree: dict):
        super().__init__()
        self._names = list(tree)
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(
                    ParamTree(v) for v in value))
            else:
                raise TypeError(f"{name}: unsupported leaf {type(value)}")

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def get(self, name: str, default=None):
        return getattr(self, name) if name in self._names else default
