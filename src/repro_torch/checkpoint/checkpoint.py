"""Fault-tolerant checkpointing (port of
``repro/checkpoint/checkpoint.py``), in the reference's on-disk format.

  * ATOMIC: a checkpoint directory becomes visible only through
    ``os.replace`` of a fully written ``.tmp_`` directory, so a writer
    stopped midway never leaves a half checkpoint that a restart would
    load.
  * COMPLETE: the train state — parameters, optimizer state, the quant
    ranges (with their telemetry slots) and ``step``.  The quant state is
    training state: dropping it would re-run the first-batch
    initialisation and fork the in-hindsight trajectory.  The
    stochastic-rounding noise is keyed by the step, so no generator state
    needs saving.
  * BOUNDED: ``keep_last`` prunes old steps after a successful write.

Format: ``<ckpt_dir>/step_<step:010d>/`` holding ``arrays.npz`` (one
``leaf_<i>`` array per leaf, ``np.savez``) and ``manifest.json`` (the
step, and each leaf's key, tree path, shape and dtype).  Leaves are keyed
by their tree path: the port's own checkpoints restore into the port's
layout, and a checkpoint the reference wrote reads through
:func:`load_arrays` / :func:`nest` and ``repro_torch.convert``.  Python
numbers in the tree (the port's ``step`` and the optimizer's ``count``)
are stored as 0-d arrays and come back as Python numbers.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models.param_tree import ParamTree
from repro_torch.runtime import sharding

_STEP_RE = re.compile(r"^step_(\d+)$")


def _children(tree):
    """``(key, child)`` pairs of a container, or ``None`` for a leaf."""
    if isinstance(tree, ParamTree):
        return [(name, tree[name]) for name in tree._names]
    if isinstance(tree, (nn.ModuleList, list, tuple)):
        return list(enumerate(tree))
    if isinstance(tree, dict):
        return list(tree.items())
    return None


def _flatten(tree, path: str = ""):
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for key, child in kids:
        yield from _flatten(child, _join(path, key))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().cpu().numpy()
    return np.asarray(leaf)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step):010d}")


def save(ckpt_dir: str, step: int, tree: Any, keep_last: int = 3, *,
         groups=None) -> str:
    """Atomically write ``tree`` as ``<ckpt_dir>/step_<step>``; returns
    that directory.

    ``groups`` (``launch.mesh.MeshGroups``: ``.data``, ``.model``): a
    rank's stored state (``sharding.store_state``, ZeRO-3).  Every rank
    of the mesh calls ``save``; each leaf is gathered whole over its
    storage groups and its model split, one leaf at a time, and the rank
    at the mesh's origin writes the whole-leaf format the reference
    writes after its ``device_get``; the others return once it has."""
    mesh = [] if groups is None else \
        [g for g in (groups.model, groups.data) if g is not None]
    lead = True
    if mesh:
        import torch.distributed as dist
        lead = all(dist.get_rank(g) == 0 for g in mesh)
    arrays, manifest = {}, {"step": int(step), "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        if isinstance(leaf, torch.Tensor) and \
                sharding.stored_of(leaf) is not None:
            if groups is None:
                raise ValueError(f"{path} is a stored share: save it with "
                                 f"the mesh's groups")
            with sharding.storage(groups.data), \
                    sharding.model_parallel(groups.model):
                leaf = sharding.leaf_whole(leaf)
        if not lead:
            continue
        key = f"leaf_{i:05d}"
        arr = _to_numpy(leaf)
        arrays[key] = arr
        manifest["leaves"].append({"key": key, "path": path,
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    if not lead:
        _mesh_barrier(mesh)
        return _step_dir(ckpt_dir, step)
    os.makedirs(ckpt_dir, exist_ok=True)

    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = _step_dir(ckpt_dir, step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    _prune(ckpt_dir, keep_last)
    _mesh_barrier(mesh)
    return final


def _mesh_barrier(groups: list) -> None:
    """Every rank of the mesh past the lead rank's write: the model group
    first, then the data group (a rank's data peers have each passed
    their model barrier with the lead's row)."""
    import torch.distributed as dist
    for g in groups:
        dist.barrier(group=g)


def _prune(ckpt_dir: str, keep_last: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_arrays(ckpt_dir: str, step: int) -> dict:
    """``{tree path: numpy array}`` of checkpoint ``step`` (a port or a
    reference checkpoint)."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        return {e["path"]: z[e["key"]] for e in manifest["leaves"]}


def nest(by_path: dict) -> dict:
    """Path-keyed arrays as nested dicts (``"a/b/c"`` -> ``t["a"]["b"]
    ["c"]``): the reference's train-state tree, for
    ``convert.train_state_from_jax``."""
    out: dict = {}
    for path, arr in by_path.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = arr
    return out


def _sub(shard, key):
    """The part of a shardings tree under ``key``: a dict's entry, or of
    a flat dict keyed by dotted parameter names (``sharding.named`` of
    ``param_pspecs``) the entries below ``key``."""
    if shard is None or isinstance(shard, tuple):
        return None
    if isinstance(shard, dict):
        if key in shard:
            return shard[key]
        pre = f"{key}."
        return {k[len(pre):]: v for k, v in shard.items()
                if k.startswith(pre)} or None
    return shard[key]


def _rebuild(template, path: str, load, shard=None):
    """``template``'s structure with every leaf replaced by ``load(path,
    leaf, placement)`` (``placement`` the leaf's ``(mesh, placements)``
    in ``shard``, or None); a ``ParamTree`` comes back as a new one whose
    parameters require grad as the template's do."""
    if isinstance(template, ParamTree):
        new = ParamTree({name: _plain(template[name], _join(path, name),
                                      load, _sub(shard, name))
                         for name in template._names})
        for p_new, p_old in zip(new.parameters(), template.parameters()):
            p_new.requires_grad_(p_old.requires_grad)
            if sharding.stored_of(p_old) is not None:
                sharding.tag_layout(p_new, sharding.stored_of(p_old))
        return new
    kids = _children(template)
    if kids is None:
        return load(path, template, shard)
    out = [(k, _rebuild(c, _join(path, k), load, _sub(shard, k)))
           for k, c in kids]
    if isinstance(template, dict):
        return dict(out)
    return type(template)(v for _, v in out)


def _plain(module, path: str, load, shard=None):
    """A sub-tree of a ``ParamTree`` as the plain dicts, lists and tensors
    its constructor takes."""
    if isinstance(module, ParamTree):
        return {name: _plain(module[name], _join(path, name), load,
                             _sub(shard, name))
                for name in module._names}
    if isinstance(module, nn.ModuleList):
        return [_plain(m, _join(path, i), load, _sub(shard, str(i)))
                for i, m in enumerate(module)]
    return load(path, module, shard)


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def restore(ckpt_dir: str, step: int, template: Any,
            device=None, shardings: Optional[Any] = None) -> Any:
    """Load ``step`` into the structure of ``template``.  Each tensor goes
    to ``device`` (default: its template leaf's device) with its template
    leaf's dtype; a Python number in the template comes back as one.
    ``shardings``: a tree of ``(mesh, placements)`` leaves shaped like
    ``template`` (``runtime.sharding.named``; parameter trees keyed by
    dotted names): each tensor is placed with ``distribute_tensor`` on
    that mesh instead, an elastic restore onto another mesh than the
    writer's.  A template leaf that is a stored share
    (``sharding.store_state``, ZeRO-3) takes the rank's share of the
    whole leaf, its layout recorded.  Raises ``KeyError`` for a leaf the
    checkpoint lacks and ``ValueError`` for a shape that differs from the
    template's (a stored share's: from its whole leaf's)."""
    by_path = load_arrays(ckpt_dir, step)

    def load(path, leaf, placed):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = by_path[path]
        st = sharding.stored_of(leaf) if isinstance(leaf, torch.Tensor) \
            else None
        want = st.leaf if st is not None else tuple(leaf.shape) \
            if isinstance(leaf, torch.Tensor) else np.shape(leaf)
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: checkpoint shape {arr.shape} != "
                             f"template {want}")
        if not isinstance(leaf, torch.Tensor):
            return type(leaf)(arr)
        if placed is not None:
            from torch.distributed.tensor import distribute_tensor
            mesh, placements = placed
            t = torch.from_numpy(arr).to(device=mesh.device_type,
                                         dtype=leaf.dtype)
            return distribute_tensor(t, mesh, list(placements))
        t = torch.from_numpy(arr).to(
            device=leaf.device if device is None else device,
            dtype=leaf.dtype)
        return t if st is None else sharding.store_leaf(t, st)

    return _rebuild(template, "", load, shardings)


def restore_migrating(ckpt_dir: str, step: int, template: dict,
                      key: str = "quant") -> tuple:
    """:func:`restore`, and for a checkpoint written without the telemetry
    slots (width-3 quant leaves) into a telemetry template (width 10):
    ``template[key]`` restored narrow and zero-padded, so the ranges carry
    over and the counters start at zero.  Returns ``(tree, migrated)``."""
    from repro_torch.core.state import tree_leaves, tree_map
    from repro_torch.telemetry.metrics import widen_state

    try:
        return restore(ckpt_dir, step, template), False
    except ValueError:
        width = tree_leaves(template[key])[0].shape[-1]
        if width == 3:
            raise
        narrow = dict(template, **{key: tree_map(lambda leaf: leaf[..., :3],
                                                 template[key])})
        out = restore(ckpt_dir, step, narrow)
        out[key] = widen_state(out[key], width)
        return out, True
