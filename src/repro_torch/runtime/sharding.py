"""Logical-axis sharding rules, activation hints and the data-parallel
context (port of ``repro/runtime/sharding.py``).

Mesh axes (see ``repro_torch.launch.mesh``):

    single-pod   (data=16, model=16)
    multi-pod    (pod=2, data=16, model=16)

The rule table is the reference's, rule for rule (MaxText-style 2D "fsdp x
tensor"): batch over the DP axes ``(pod, data)``; a weight's wide matmul
dim over ``model`` (Megatron column-parallel qkv/up, row-parallel o/down),
the other over ``data`` (ZeRO-3 storage); MoE experts over ``model``;
quantization-range state replicated.  A spec is :class:`P`, a tuple of
per-dim entries (a mesh axis name, a tuple of them, or ``None``): the port
cannot import JAX's ``PartitionSpec``.  :func:`placements` maps one onto
``torch.distributed`` DTensor placements (``Shard(d)`` / ``Replicate()``)
and :func:`named` does so for a tree, as the reference's ``named`` builds
``NamedSharding``\\s.

Layout.  The port stores one entry per layer (``repro_torch.convert``);
the reference stacks ``decoder/blocks`` and prepends ``None`` for the
repeats dim.  A per-layer leaf's spec here is the reference's without that
leading entry.  Paths are the parameters' dotted names read with ``/``
(``decoder/layers/3/moe/w_up``), so the reference's path tests
(``/moe/``, ``/time/``, ``/chan/``, ``/rglru/``, ``shared``) read the
same.

Hints.  ``hint``, ``hint_heads``, ``attn_hints`` and ``replicate_hint``
return their input objects unchanged when no mapping is active, as the
reference's do.  Under an active mapping they compute the reference's
spec and record it (``activation_hints(..., record=list)``) and still
return the input: a rank's tensors are already its shards, which the
model code computes itself under :func:`model_parallel`.

Model parallelism.  :func:`model_parallel` makes a process group the
active ``model`` group (one rank per model coordinate,
``launch.mesh.mesh_groups``).  Inside it a rank holds its compute shards
of the parameters (:func:`shard_params`: the attention heads by
:func:`attn_layout`, the MLP's ``d_ff``, the routed experts, the
vocabulary of ``embed`` / ``head``, the RG-LRU's channels, the RWKV-6
time mix's heads and channel mix's ``d_ff``), and the layers compute
what the one-process program computes: Megatron's column / row pairs (an
int32 ``all_reduce`` of a row-parallel product's K-shard partials before
its epilogue), the experts a rank holds, the vocab-parallel embedding and
cross entropy, the channel-parallel RG-LRU and the head-parallel WKV.
Megatron's f and g are :func:`mp_grad_sum` (identity, the gradient
summed) and :func:`mp_sum` (summed, the gradient passed through);
:func:`mp_take` is a rank's slice of a whole tensor (its gradient
gathered) and :func:`mp_gather` the inverse.  Where neither attention
head dim divides the model axis, :func:`attn_layout` gives the
reference's sequence-parallel core (``"seq"``): each rank runs its ``S /
M`` query rows against the gathered keys and values
(``models.attention``) on the whole attention weights (``wq`` / ``wo`` /
``bq`` gathered from their head shards, :func:`mp_gather_sum`), and the
weights' gradients, partial sums over a rank's rows, are summed over the
group.  Where that core does not apply either (decode, a prefill that
fills a cache, the local and chunked paths), :func:`attn_layout` gives
the reference's third layout, padded head sharding (``"g_pad"`` /
``"kv_pad"``: the dim :func:`choose_head_axis` picks).  A rank then
holds :func:`split_range`'s share of that dim, ``[r c, min((r + 1) c,
n))`` with ``c = ceil(n / M)``: GSPMD's padded layout with the padding
removed, so a rank may hold fewer than ``c`` heads or none, and no
padding reaches a statistic.  :func:`mp_slice`, :func:`mp_take`,
:func:`mp_gather` (``total=``), :func:`shard_params` and
:func:`gather_named` cut and join on that split, which is the even one
where ``M`` divides ``n``.  Decode caches follow :func:`cache_pspecs`:
:func:`kv_cache_split` (a rank's KV heads, else its slots of the cache
length, else whole) and :func:`pos_cache_split`, recorded on the cache
tensors (:func:`cache_split_of`).
:func:`param_pspecs` stays the reference's storage rule (its ``model``
entries at the production model size).

Sequence parallelism (the reference's ``"seq": "model"`` mapping,
Megatron-SP).  Inside :func:`sequence_parallel` under a model group
(:func:`seq_rows`; the step factories' ``seq_shard``) the residual
stream at every block boundary is the rank's :func:`split_range` rows
of the sequence (an uneven S gives ranks fewer rows, decode's S = 1
gives rank 0 the row and the others none), so a checkpointed unit saves
the rank's rows.  The lookup's vocab-parallel sum is a reduce-scatter
onto them (:func:`mp_scatter`: one nonzero term a row, exact), a
frontend's whole output takes them (:func:`mp_take`), and every norm
runs on them, its parameters' gradients summed over the group
(:func:`mp_grad_sum`).  A sublayer gathers its normed rows whole in the
compute dtype (:func:`mp_gather`; the gradient keeps the rank's rows)
and leaves by one of two exits.  A row-parallel product reduce-scatters
its int32 partials onto the rank's rows before the epilogue
(:func:`mp_scatter_now`: the one-process product bit for bit; its
cotangent gathered back, :func:`mp_gather_now`; its gradient site and
bias on the rows): the head layouts' ``wo``, the MLP's ``w_down`` (a
shared expert's too), the RG-LRU's ``w_out``, the RWKV-6 time mix's
``w_o`` and channel mix's ``w_v``.  A column-parallel product on the
gathered rows reduce-scatters its ``dx`` partial in fp32 onto them
instead of summing it whole (:func:`mp_embed` places it among zeros for
the gather, which keeps the rank's rows): the MLP's ``w_up`` /
``w_gate``, the RG-LRU's ``w_in`` / ``w_gate``, the head layouts' q (and
k / v where KV is split); the RWKV-6 mixes' column products read the
token shift, whose cotangent crosses rows, and sum theirs whole.  A
tensor whole on every rank after its sublayer takes the rows
(:func:`mp_take`): the routed experts' output after the combine, the
channel mix's gate.  The ``"seq"`` attention core runs on the rank's
rows as it is (no gather, no output gather).  The final norms' rows are
gathered for the head, the loss and ``enc_out``.

ZeRO-3 storage.  :func:`store_state` cuts a whole train state into a
rank's stored state by that rule at the mesh's sizes (:func:`layout_of`,
recorded on each leaf as a :class:`Stored` layout, the optimizer
moments with their parameters): a ``"data"`` entry stores the rank's
share of its compute shard, a ``("data", "model")`` entry (``wq`` /
``wk`` / ``wv`` / ``wo`` where the heads do not divide) its share of
the whole leaf over the grid, row-major ``d * M + m``, and a ``"model"``
entry on a leaf whole for compute (``patch_proj``, ``enc_in``) its share
over the model group; an axis ``_pad_spec`` drops leaves the leaf whole
on it.  A stored weight is gathered where it is used (``core.qlinear``'s
weight site, :func:`unstore`: over the :func:`storage` data group and
the model group, the compute shard then cut), and its gradient is
reduce-scattered back onto the share (:func:`scatter_stored`: summed
over the data group where the step's batch is sharded, sliced
otherwise).  :func:`leaf_whole` gathers a leaf whole (the checkpoint's
save from shares) and :func:`gather_state` is :func:`store_state`'s
inverse in one process.

Data parallelism.  ``torch.distributed`` runs one controller per rank,
where the reference's ``jit`` over the ``data`` axis is one program.
:func:`data_parallel` makes a process group the active data-parallel
group of the train step (``runtime.steps``); inside it the helpers below
give what GSPMD gives the reference's global program: the sum / mean of a
per-rank partial over every rank (autograd-aware), the global (min, max)
of an observed tensor, and the rank's rows of a global batch.  Outside it
each is the single-device computation, op for op.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch

Tree = Any


class P(tuple):
    """A partition spec: one entry per tensor dim (a mesh axis name, a
    tuple of names, or ``None``); ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# Activation hints.
# ---------------------------------------------------------------------------
_HINTS: Optional[dict] = None
_RECORD: Optional[list] = None


@contextlib.contextmanager
def activation_hints(mapping: dict, record: Optional[list] = None):
    """mapping: logical axis name -> mesh axis (str/tuple) or None (plus
    ``model_size``).  ``record``: a list that receives ``(site, spec)`` of
    every hint taken inside the block."""
    global _HINTS, _RECORD
    prev = _HINTS, _RECORD
    _HINTS, _RECORD = mapping, record
    try:
        yield
    finally:
        _HINTS, _RECORD = prev


def _note(site: str, spec: P) -> None:
    if _RECORD is not None:
        _RECORD.append((site, spec))


def hint(x, *logical_axes):
    """The active mapping of ``logical_axes`` (one per dim; None =
    unconstrained) for ``x``; ``x`` itself is returned."""
    if _HINTS is None:
        return x
    _note("hint", P(*[None if a is None else _HINTS.get(a)
                      for a in logical_axes]))
    return x


def choose_head_axis(kv: int, g: int, msize: int) -> str:
    """'kv' or 'g': which head dim to shard over the model axis.  Exact
    division wins; otherwise the larger dim (GSPMD pads the remainder)."""
    if kv % msize == 0:
        return "kv"
    if g % msize == 0:
        return "g"
    return "g" if g >= kv else "kv"


def replicate_hint(x):
    """Full replication at this point (the int8 weight gather's pin)."""
    if _HINTS is None:
        return x
    _note("replicate", P())
    return x


def attn_hints(q, k, v, *, allow_seq: bool):
    """The reference's layout choice for the attention core ``[B, S, KV,
    G, hd]`` / ``[B, S, KV, hd]``: exact head sharding, else the sequence
    (context-parallel) core where ``allow_seq`` and S divides, else padded
    head sharding.  Returns ``(q, k, v)`` unchanged."""
    if _HINTS is None:
        return q, k, v
    maxis, msize = _HINTS.get("model"), _HINTS.get("model_size")
    bspec = _HINTS.get("batch")
    if maxis is None or not msize:
        return q, k, v
    kv, g, s = q.shape[2], q.shape[3], q.shape[1]
    if kv % msize == 0 or g % msize == 0:
        hint_heads(q, kv_axis=2, g_axis=3)
        if k is not None:
            hint_heads(k, kv_axis=2, g_axis=2)
            hint_heads(v, kv_axis=2, g_axis=2)
        return q, k, v
    if allow_seq and s % msize == 0:
        _note("attn_seq", P(bspec, maxis, None, None, None))
        return q, k, v
    hint_heads(q, kv_axis=2, g_axis=3)
    return q, k, v


def hint_heads(q, kv_axis: int, g_axis: int):
    """Heads over the ``model`` axis: whichever of the KV / G dims divides
    its size (otherwise the larger, padded); a single head dim only when
    it divides.  Returns ``q``."""
    if _HINTS is None:
        return q
    maxis, msize = _HINTS.get("model"), _HINTS.get("model_size")
    if maxis is None or not msize:
        return q
    kv, g = q.shape[kv_axis], q.shape[g_axis]
    axes = [None] * q.dim()
    axes[0] = _HINTS.get("batch")
    if kv_axis == g_axis:
        if kv % msize:
            return q
        axes[kv_axis] = maxis
    else:
        which = choose_head_axis(kv, g, msize)
        axes[kv_axis if which == "kv" else g_axis] = maxis
    _note("heads", P(*axes))
    return q


# ---------------------------------------------------------------------------
# Parameter rules.
# ---------------------------------------------------------------------------
DEFAULT_MODEL_SIZE = 16   # model-axis extent of the production meshes


def _param_rule(pathstr: str, name: str, shape: tuple) -> Optional[tuple]:
    """Spec entries for the TRAILING logical dims of a leaf."""
    moe_routed = "/moe/" in pathstr + "/" and "shared" not in pathstr
    ms = DEFAULT_MODEL_SIZE
    if name == "embed":
        return ("model", "data")          # [V, D]
    if name == "head":
        return ("data", "model")          # [D, V]
    if name in ("patch_proj", "enc_in"):
        return (None, "model")
    if name == "wq":                      # [D, KV, G, hd] head-major
        kv, g = shape[-3], shape[-2]
        if kv % ms == 0:
            return ("data", "model", None, None)
        if g % ms == 0:
            return ("data", None, "model", None)
        # head counts that do not divide the model axis (nemotron KV=8,
        # G=12): d_model over both axes, so parameters and optimizer state
        # still scale with the full chip count
        return (("data", "model"), None, None, None)
    if name in ("wk", "wv"):              # [D, KV, hd]
        kv = shape[-2]
        if kv % ms == 0:
            return ("data", "model", None)
        return (("data", "model"), None, None)
    if name == "wo":                      # [KV, G, hd, D]
        kv, g = shape[-4], shape[-3]
        if kv % ms == 0:
            return ("model", None, None, "data")
        if g % ms == 0:
            return (None, "model", None, "data")
        return (None, None, None, ("data", "model"))
    if name == "bq":                      # [KV, G, hd]
        kv, g = shape[-3], shape[-2]
        if choose_head_axis(kv, g, ms) == "kv":
            return ("model", None, None)
        return (None, "model", None)
    if name in ("bk", "bv"):              # [KV, hd]
        return ("model" if shape[-2] % ms == 0 else None, None)
    if name == "b_up":
        return ("model",)
    if name in ("bo", "b_down"):
        return (None,)
    if moe_routed:
        if name in ("w_up", "w_gate"):
            return ("model", "data", None)   # [E, D, F]
        if name == "w_down":
            return ("model", None, "data")   # [E, F, D]
        if name == "router":
            return (None, None)
    if name in ("w_up", "w_gate"):
        return ("data", "model")
    if name == "w_down":
        return ("model", "data")
    if "/time/" in pathstr + "/":
        if name in ("w_r", "w_k", "w_v", "w_g"):
            return ("data", "model")
        if name == "w_o":
            return ("model", "data")
    if "/chan/" in pathstr + "/":
        if name in ("w_k", "w_r"):
            return ("data", "model")
        if name == "w_v":
            return ("model", "data")
    if "/rglru/" in pathstr + "/":
        if name in ("w_in", "w_gate"):
            return ("data", "model")
        if name == "w_out":
            return ("model", "data")
        if name in ("w_a", "w_x"):
            return ("model", None)
        if name == "conv_w":
            return (None, "model")
        if name in ("conv_b", "b_a", "b_x", "lambda"):
            return ("model",)
    return None  # replicated (norms, small vectors, scalars)


def _pad_spec(rule: Optional[tuple], shape: tuple, axis_sizes: dict) -> P:
    """Left-pad the rule to the leaf rank and DROP any axis that does not
    divide the dimension (a placement must divide exactly)."""
    if rule is None:
        return P()
    ndim = len(shape)
    assert ndim >= len(rule), (rule, shape)
    full = (None,) * (ndim - len(rule)) + tuple(rule)
    out = []
    for dim, ax in zip(shape, full):
        if ax is None:
            out.append(None)
            continue
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= axis_sizes.get(a, DEFAULT_MODEL_SIZE)
        out.append(ax if dim % size == 0 else None)
    return P(*out)


def axis_sizes(mesh=None) -> dict:
    """``{axis name: extent}`` of a ``DeviceMesh`` or of such a dict; the
    production mesh's 16 x 16 without one."""
    if mesh is None:
        return {"data": DEFAULT_MODEL_SIZE, "model": DEFAULT_MODEL_SIZE}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _walk(tree, path: tuple, fn):
    """``fn(path, leaf)`` over a parameter-shaped tree: a module (its
    named parameters, dotted names split), a dict, a list."""
    if isinstance(tree, torch.nn.Module):
        return {name: fn(path + tuple(name.split(".")), p)
                for name, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _walk(v, path + tuple(str(k).split(".")), fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, path + (str(i),), fn)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_pspecs(params: Tree, mesh=None) -> Tree:
    """Spec tree for a parameter-shaped tree (a ``ParamTree``: ``{dotted
    name: P}``; or optimizer moments keyed by those names): rules match by
    trailing path names.  Non-tensor leaves (a step count) are ``P()``."""
    sizes = axis_sizes(mesh)

    def spec(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return P()
        return _pad_spec(_param_rule("/".join(path), path[-1],
                                     tuple(leaf.shape)),
                         tuple(leaf.shape), sizes)
    return _walk(params, (), spec)


def replicated_pspecs(tree: Tree) -> Tree:
    return _walk(tree, (), lambda path, leaf: P())


def train_state_pspecs(state: dict, mesh=None) -> dict:
    """``{params, opt, quant, step}`` -> specs (quant/step replicated)."""
    return {"params": param_pspecs(state["params"], mesh),
            "opt": param_pspecs(state["opt"], mesh),
            "quant": replicated_pspecs(state["quant"]),
            "step": P()}


# ---------------------------------------------------------------------------
# Batch / cache rules.
# ---------------------------------------------------------------------------
def _divides(n: int, sizes: dict, axes) -> bool:
    if axes is None:
        return False
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= sizes[a]
    return n % size == 0


def _dp_entry(dp_axes):
    dp_axes = tuple(dp_axes)
    return dp_axes if len(dp_axes) > 1 else dp_axes[0]


def batch_pspecs(batch: Tree, mesh, dp_axes) -> Tree:
    """Dim 0 (the global batch) over the DP axes when they divide it."""
    sizes = axis_sizes(mesh)
    lead_axes = _dp_entry(dp_axes)

    def spec(path, leaf):
        if leaf.dim() == 0:
            return P()
        lead = lead_axes if _divides(leaf.shape[0], sizes, lead_axes) \
            else None
        return P(lead, *((None,) * (leaf.dim() - 1)))
    return _walk(batch, (), spec)


def kv_cache_split(n_kv: int, length: int, msize: int) -> Optional[int]:
    """The dim of a ``[B, L, KV, hd]`` k / v cache a model rank holds a
    slice of (``cache_pspecs``' k/v rule): the KV heads (2) where they
    divide the model axis, else the cache length (1) where it divides
    (decode's softmax then runs over the group), else None (whole)."""
    if n_kv % msize == 0:
        return 2
    return 1 if length % msize == 0 else None


def pos_cache_split(length: int, msize: int) -> Optional[int]:
    """The dim of a ``[B, L]`` position cache a model rank holds a slice
    of (``cache_pspecs``' pos rule): the length where it divides."""
    return 1 if length % msize == 0 else None


def cache_split_of(t: torch.Tensor) -> Optional[tuple]:
    """``(dim, whole size)`` of a cache tensor a model rank holds a slice
    of (recorded by ``models.attention.init_kv_cache``), or None."""
    return getattr(t, "model_split", None)


def cache_pspecs(cache: Tree, mesh, dp_axes) -> Tree:
    """Decode caches (one entry per layer): batch over DP; heads, the
    cache length or state channels over ``model``."""
    sizes = axis_sizes(mesh)
    bax = _dp_entry(dp_axes)

    def spec(path, leaf):
        name, core = path[-1], tuple(leaf.shape)
        bdim = bax if _divides(core[0], sizes, bax) else None
        msize = sizes["model"]
        if name in ("k", "v"):                       # [B, L, KV, hd]
            # KV heads over model; when they do not divide, the cache
            # length (the decode memory bill scales with the mesh)
            sp = [bdim, None, None, None]
            d = kv_cache_split(core[2], core[1], msize)
            if d is not None:
                sp[d] = "model"
            sp = tuple(sp)
        elif name == "pos":                          # [B, L]
            sp = (bdim, "model" if pos_cache_split(core[1], msize)
                  else None)
        elif name == "state":                        # [B, H, hd, hd]
            sp = (bdim, "model" if _divides(core[1], sizes, "model")
                  else None, None, None)
        elif name == "h":                            # [B, C]
            sp = (bdim, "model" if _divides(core[1], sizes, "model")
                  else None)
        elif name == "conv":                         # [B, 3, C]
            sp = (bdim, None, "model" if _divides(core[2], sizes, "model")
                  else None)
        elif name in ("x_time", "x_chan"):           # [B, D]
            sp = (bdim, None)
        else:
            sp = (None,) * len(core)
        return P(*sp)
    return _walk(cache, (), spec)


# ---------------------------------------------------------------------------
# DTensor placements.
# ---------------------------------------------------------------------------
def placements(spec: P, mesh) -> tuple:
    """``spec`` as one DTensor placement per mesh dim: ``Shard(d)`` where
    tensor dim d names that mesh axis (alone or in a tuple, major first),
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named(tree_pspecs: Tree, mesh) -> Tree:
    """A spec tree as ``(mesh, placements)`` leaves: what
    ``checkpoint.restore(shardings=...)`` and ``distribute_tensor``
    take."""
    if isinstance(tree_pspecs, P):
        return (mesh, placements(tree_pspecs, mesh))
    if isinstance(tree_pspecs, dict):
        return {k: named(v, mesh) for k, v in tree_pspecs.items()}
    if isinstance(tree_pspecs, (list, tuple)):
        return type(tree_pspecs)(named(v, mesh) for v in tree_pspecs)
    raise TypeError(f"not a spec tree leaf: {tree_pspecs!r}")


# ---------------------------------------------------------------------------
# The data-parallel context of the train step.
# ---------------------------------------------------------------------------
_DP: Optional[tuple] = None     # (group, rank, world)


@contextlib.contextmanager
def data_parallel(group):
    """Make ``group`` (a ``torch.distributed`` process group, one rank per
    batch shard) the active data-parallel group inside the block."""
    import torch.distributed as dist
    global _DP
    prev = _DP
    _DP = (group, dist.get_rank(group), dist.get_world_size(group))
    try:
        yield
    finally:
        _DP = prev


def dp_shard() -> Optional[tuple]:
    """``(rank, world)`` of the active data-parallel group, or None."""
    return None if _DP is None else _DP[1:]


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active group's ranks (gradients flow back to
    every rank's partial); ``x`` without one."""
    if _DP is None:
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, group=_DP[0])


def dp_mean(x: torch.Tensor, dims=None) -> torch.Tensor:
    """``torch.mean(x, dims)`` (all dims with None) over the global batch:
    every rank's sums, over every rank's count of elements."""
    if _DP is None:
        return torch.mean(x) if dims is None else torch.mean(x, dim=dims)
    if dims is None:
        return dp_sum(torch.sum(x)) / (x.numel() * _DP[2])
    n = 1
    for d in (dims if isinstance(dims, tuple) else (dims,)):
        n *= x.shape[d]
    return dp_sum(torch.sum(x, dim=dims)) / (n * _DP[2])


def dp_share(x: torch.Tensor) -> torch.Tensor:
    """A term every rank computes from global values, as this rank's
    share of the loss (its gradients are summed over the ranks)."""
    return x if _DP is None else x / _DP[2]


def dp_minmax(mn: torch.Tensor, mx: torch.Tensor):
    """The (min, max) over every rank's observation (one all_reduce MAX of
    ``(-min, max)``, exact in any order)."""
    if _DP is None:
        return mn, mx
    import torch.distributed as dist
    buf = torch.stack([-mn.to(torch.float32), mx.to(torch.float32)])
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=_DP[0])
    return (-buf[0]).to(mn.dtype), buf[1].to(mx.dtype)


def site_groups(split_model: bool) -> list:
    """The groups a site's tensor is split over: the data-parallel rows
    where a data group is active, the model shard where ``split_model``
    and a model group is active (``(group, rank, size)`` contexts)."""
    return [g for g, on in ((_DP, True), (_MP, split_model))
            if g is not None and on]


def group_sum(x: torch.Tensor, groups: list) -> torch.Tensor:
    """``x`` summed over each of ``groups`` in turn, outside autograd."""
    for g in groups:
        x = _all_reduce(x, "sum", g)
    return x


def group_max(x: torch.Tensor, groups: list) -> torch.Tensor:
    """The elementwise max of ``x`` over ``groups`` (exact)."""
    for g in groups:
        x = _all_reduce(x, "max", g)
    return x


def shard_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows ``[r n / N, (r + 1) n / N)`` of a global tensor."""
    if _DP is None:
        return x
    _, r, world = _DP
    n = x.shape[dim] // world
    return x.narrow(dim, r * n, n)


# ---------------------------------------------------------------------------
# The model-parallel context: Megatron pairs, experts, the vocabulary.
# ---------------------------------------------------------------------------
_MP: Optional[tuple] = None     # (group, rank, size)


@contextlib.contextmanager
def model_parallel(group):
    """Make ``group`` (a ``torch.distributed`` process group, one rank per
    ``model`` coordinate) the active model-parallel group inside the
    block; a group of one rank (or None) is the one-process program."""
    global _MP
    prev = _MP
    if group is None:
        _MP = None
    else:
        import torch.distributed as dist
        size = dist.get_world_size(group)
        _MP = None if size == 1 else (group, dist.get_rank(group), size)
    try:
        yield
    finally:
        _MP = prev


def mp_shard() -> Optional[tuple]:
    """``(rank, size)`` of the active model group, or None."""
    return None if _MP is None else _MP[1:]


def split_range(n: int, msize: int, r: int) -> tuple:
    """``(start, count)`` of model rank ``r``'s share of ``n`` over
    ``msize`` ranks: ``[r c, min((r + 1) c, n))`` with ``c = ceil(n /
    msize)``, GSPMD's padded layout with the padding removed (``[r n /
    M, (r + 1) n / M)`` where ``msize`` divides ``n``; a rank may hold
    fewer than ``c``, or none)."""
    c = -(-n // msize)
    lo = min(r * c, n)
    return lo, min(lo + c, n) - lo


def mp_slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's share (:func:`split_range`) of ``dim``."""
    if _MP is None:
        return x
    _, r, m = _MP
    lo, n = split_range(x.shape[dim], m, r)
    return x.narrow(dim, lo, n)


def _all_reduce(x: torch.Tensor, op: str, grp=None) -> torch.Tensor:
    """A copy of ``x`` reduced (``"sum"`` / ``"max"``) over ``grp`` (a
    ``(group, rank, size)`` context; the active model group by default),
    outside autograd."""
    import torch.distributed as dist
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, op.upper()),
                    group=(grp or _MP)[0])
    return y


class _GradSum(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the model
    group (a replicated input whose consumers hold shards)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum")


class _Sum(torch.autograd.Function):
    """Megatron's g: the partials summed over the model group, the gradient
    passed through (every rank's consumers compute the same full
    cotangent)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g


def _all_gather(x: torch.Tensor, dim: int, total: Optional[int] = None,
                grp=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, outside autograd, over
    ``grp`` (a ``(group, rank, size)`` context; the active model group by
    default).  ``total``: the whole size of ``dim``, whose shares
    (:func:`split_range`) may differ between ranks: each is padded to
    ``ceil(total / M)`` for the collective and the padding dropped."""
    import torch.distributed as dist
    grp = grp or _MP
    x = x.detach().contiguous()
    if total is not None:
        dim = dim % x.dim()
        c = -(-total // grp[2])
        if x.shape[dim] < c:
            pad = list(x.shape)
            pad[dim] = c - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(x) for _ in range(grp[2])]
    dist.all_gather(parts, x, group=grp[0])
    out = torch.cat(parts, dim=dim)
    return out if total is None else out.narrow(dim, 0, total)


class _Gather(torch.autograd.Function):
    """The ranks' shards concatenated along ``dim`` (all_gather); the
    gradient is this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim, total):
        ctx.dim = dim
        return _all_gather(x, dim, total)

    @staticmethod
    def backward(ctx, g):
        return mp_slice(g, ctx.dim).contiguous(), None, None


class _GatherSum(torch.autograd.Function):
    """A tensor whole on every rank from the ranks' shards (all_gather),
    whose consumers on each rank give a partial cotangent: the gradient is
    this rank's slice of the cotangents summed over the group (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, total):
        ctx.dim = dim
        return _all_gather(x, dim, total)

    @staticmethod
    def backward(ctx, g):
        return mp_slice(_all_reduce(g, "sum"), ctx.dim).contiguous(), \
            None, None


def mp_grad_sum(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f (:class:`_GradSum`); ``x`` without a model group."""
    return x if _MP is None else _GradSum.apply(x)


def mp_sum(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g (:class:`_Sum`); ``x`` without a model group."""
    return x if _MP is None else _Sum.apply(x)


def mp_gather(x: torch.Tensor, dim: int,
              total: Optional[int] = None) -> torch.Tensor:
    """The whole tensor from the ranks' shards along ``dim``
    (:class:`_Gather`; ``total``: the whole size, for shares of
    :func:`split_range` that differ); ``x`` without a model group."""
    return x if _MP is None else _Gather.apply(x, dim, total)


def mp_gather_sum(x: torch.Tensor, dim: int, total: int) -> torch.Tensor:
    """A head-sharded weight whole on every rank for consumers that each
    see a share of the rows (the sequence-parallel core):
    :class:`_GatherSum`; ``x`` without a model group."""
    return x if _MP is None else _GatherSum.apply(x, dim, total)


class _Take(torch.autograd.Function):
    """This rank's slice of a tensor every rank holds whole, along
    ``dim``; the gradient is the ranks' slices of the cotangent gathered
    (each rank's consumers hold its slice), so a whole producer sees the
    whole cotangent on every rank."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.total = dim, x.shape[dim]
        return mp_slice(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.total), None


def mp_take(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's slice of a whole tensor along ``dim``, its
    gradient gathered (:class:`_Take`); ``x`` without a model group."""
    return x if _MP is None else _Take.apply(x, dim)


# ---------------------------------------------------------------------------
# The sequence-parallel residual stream (the reference's "seq": "model").
# ---------------------------------------------------------------------------
_SP = False


@contextlib.contextmanager
def sequence_parallel(on: bool = True):
    """Inside the block, under a model group of more than one rank, the
    residual stream at every block boundary is the rank's rows of the
    sequence (:func:`seq_rows`): the step factories' ``seq_shard``."""
    global _SP
    prev, _SP = _SP, bool(on)
    try:
        yield
    finally:
        _SP = prev


def seq_rows() -> bool:
    """Whether the residual stream is the rank's :func:`split_range` rows
    of the sequence: :func:`sequence_parallel` under a model group."""
    return _SP and _MP is not None


def mp_gather_now(x: torch.Tensor, dim: int,
                  total: Optional[int] = None) -> torch.Tensor:
    """The ranks' shares of ``dim`` concatenated (``total``: the whole
    size, for :func:`split_range`'s uneven shares), outside autograd;
    ``x`` without a model group."""
    return x if _MP is None else _all_gather(x, dim, total)


def mp_scatter_now(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` summed over the model group and this rank's
    :func:`split_range` share of ``dim`` kept (a reduce-scatter: int32
    partials exact, fp32 in the collective's order), outside autograd;
    ``x`` without a model group."""
    return x if _MP is None else _reduce_scatter(x, dim, _MP, uneven=True)


def mp_embed(x: torch.Tensor, dim: int, total: int) -> torch.Tensor:
    """This rank's :func:`split_range` share ``x`` of ``dim`` placed in a
    tensor of the whole size ``total`` there, zeros elsewhere; ``x``
    without a model group."""
    if _MP is None:
        return x
    shape = list(x.shape)
    shape[dim] = total
    out = x.new_zeros(shape)
    out.narrow(dim, *split_range(total, _MP[2], _MP[1])).copy_(x)
    return out


class _Scatter(torch.autograd.Function):
    """A product's partials summed over the model group onto this rank's
    rows of ``dim`` (a reduce-scatter); the gradient is the ranks' rows of
    the cotangent gathered (each rank's consumers hold its rows)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.total = dim, x.shape[dim]
        return mp_scatter_now(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.total), None


class _GradScatter(torch.autograd.Function):
    """Identity forward on a tensor gathered from the ranks' rows of
    ``dim``, whose consumers here each give a partial cotangent: the
    gradient is the partials summed over the model group onto this
    rank's rows (a reduce-scatter, the gather's conjugate), zeros on the
    other rows, which the gather's backward drops."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mp_embed(mp_scatter_now(g, ctx.dim), ctx.dim,
                        g.shape[ctx.dim]), None


def mp_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Megatron-SP's row-parallel exit (:class:`_Scatter`); ``x`` without
    a model group."""
    return x if _MP is None else _Scatter.apply(x, dim)


def mp_grad_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Megatron-SP's column-parallel entry (:class:`_GradScatter`); ``x``
    without a model group."""
    return x if _MP is None else _GradScatter.apply(x, dim)


def mp_sum_now(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group outside autograd (int32
    partials, a backward pass's fp32 partials; exact for integers);
    ``x`` without one."""
    return x if _MP is None else _all_reduce(x, "sum")


def mp_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model group (exact), detached."""
    return x if _MP is None else _all_reduce(x, "max")


def mp_sum_ordered(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group in rank order (all_gather, then
    the ranks' terms added from rank 0 up), outside autograd: every rank
    gets the same bits; ``x`` without one."""
    if _MP is None:
        return x
    parts = _all_gather(x[None], 0)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def mp_minmax(mn: torch.Tensor, mx: torch.Tensor):
    """The (min, max) over every model rank's shard (one all_reduce MAX
    of ``(-min, max)``, exact); idempotent on a replicated tensor."""
    if _MP is None:
        return mn, mx
    buf = mp_max(torch.stack([-mn.to(torch.float32), mx.to(torch.float32)]))
    return (-buf[0]).to(mn.dtype), buf[1].to(mx.dtype)


def mp_replicated_stats(st: torch.Tensor) -> torch.Tensor:
    """A site's statistics vector over a tensor every model rank holds
    whole: its additive telemetry counters (clip, n, err, sig) kept on
    model rank 0 and zeroed on the others, so a SUM over the mesh counts
    the site once (min / max / visited and the max-combined slots are
    idempotent)."""
    if _MP is None or _MP[1] == 0 or st.shape[-1] <= 3:
        return st
    from repro_torch.telemetry.config import T_CLIP, T_UTIL
    st = st.clone()
    st[..., T_CLIP:T_UTIL] = 0.0
    return st


def attn_layout(kv: int, g: int, msize: int, s: Optional[int] = None,
                allow_seq: bool = False) -> str:
    """The attention core's layout over a model axis of ``msize``, in the
    reference's preference order (``attn_hints``): ``"kv"`` or ``"g"``
    where that head dim divides (:func:`choose_head_axis`), else
    ``"seq"``, the sequence-parallel core, where ``allow_seq`` (the
    layer's dense-path predicate, the reference's ``will_use_dense``) and
    ``msize`` divides the ``s`` query rows, else the reference's third
    layout, padded head sharding (decode, a prefill that fills a cache,
    the local and chunked paths): ``"g_pad"`` or ``"kv_pad"``, the dim
    :func:`choose_head_axis` picks (G where ``g >= kv``), each rank its
    :func:`split_range` share of it."""
    if kv % msize == 0:
        return "kv"
    if g % msize == 0:
        return "g"
    if allow_seq and s is not None and s % msize == 0:
        return "seq"
    return choose_head_axis(kv, g, msize) + "_pad"


_ATTN_NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_MLP_NAMES = ("w_up", "w_gate", "w_down", "b_up")
# The recurrent blocks' rules (reference ``_param_rule``'s ``/time/``,
# ``/chan/`` and ``/rglru/``): the dim a model rank holds a slice of.
_BLOCK_DIMS = {
    "time": {"w_r": 1, "w_k": 1, "w_v": 1, "w_g": 1, "w_o": 0},
    "chan": {"w_k": 1, "w_r": 1, "w_v": 0},
    "rglru": {"w_in": 1, "w_gate": 1, "w_out": 0, "w_a": 0, "w_x": 0,
              "conv_w": 1, "conv_b": 0, "b_a": 0, "b_x": 0, "lambda": 0},
}


def compute_dim(path: tuple, shape: tuple, msize: int) -> Optional[int]:
    """The dim of a parameter leaf (``path``: its dotted name split) that
    a model rank holds a shard of, or None (replicated): the attention
    heads by :func:`attn_layout` (where neither head dim divides, ``wq``
    / ``wo`` / ``bq`` on the padded dim, :func:`split_range`'s uneven
    shares; ``wk`` / ``wv`` / ``bk`` / ``bv`` whole), the MLP's
    ``d_ff`` (a shared expert's too), the routed experts, the vocabulary
    of ``embed`` and ``head``, and the recurrent blocks' channels: the
    RG-LRU's ``lru_width``, the RWKV-6 time mix's heads and channel
    mix's ``d_ff`` (their LoRAs, ``u``, ``w0``, ``mu*`` and ``ln_x_*``
    stay whole, as the reference's rule table leaves them).  The padded
    head dim, the routed experts and the vocabulary take
    :func:`split_range`'s shares where ``msize`` does not divide them
    (GSPMD's padded layout: the reference's storage drops such an axis,
    its in-graph hints pad it); elsewhere a rule's dim that does not
    divide ``msize`` raises (the MLP's ``d_ff`` and the recurrent
    blocks' channels, which the port does not pad)."""
    if msize == 1:
        return None
    name = path[-1]
    dim, padded = None, False
    block = next((b for b in _BLOCK_DIMS if b in path), None)
    if block is not None:
        dim = _BLOCK_DIMS[block].get(name)
    elif name in ("embed", "head"):
        dim, padded = (0 if name == "embed" else 1), True
    elif name in _ATTN_NAMES:
        if name in ("wq", "wo", "bq"):
            kv, g = (shape[1], shape[2]) if name == "wq" else shape[:2]
            padded = bool(kv % msize and g % msize)
            dim = (1 if name == "wq" else 0) + \
                (0 if choose_head_axis(kv, g, msize) == "kv" else 1)
        else:   # wk, wv [D, KV, hd]; bk, bv [KV, hd]: heads when KV divides
            d = 1 if name in ("wk", "wv") else 0
            dim = d if shape[d] % msize == 0 else None
    elif "moe" in path and "shared" not in path and \
            name in ("w_up", "w_gate", "w_down"):
        dim, padded = 0, True
    elif name in _MLP_NAMES:
        dim = 0 if name in ("w_down", "b_up") else 1
    if dim is not None and shape[dim] % msize and not padded:
        raise ValueError(f"{'.'.join(path)}: dim {dim} of {tuple(shape)} "
                         f"does not split over {msize} model ranks")
    return dim


def model_dim_of(p: torch.Tensor) -> Optional[int]:
    """The dim of a parameter that :func:`shard_params` cut (None: whole
    on every model rank)."""
    return getattr(p, "model_dim", None)


def _rebuild(params, fn):
    """A ``ParamTree`` shaped like ``params`` with ``fn(path, tensor)`` at
    every leaf (whole parameters: :func:`model_dim_of` None)."""
    from repro_torch.models.param_tree import ParamTree

    def plain(mod, path):
        if isinstance(mod, ParamTree):
            return {n: plain(mod[n], path + (n,)) for n in mod._names}
        if isinstance(mod, torch.nn.ModuleList):
            return [plain(m, path + (str(i),)) for i, m in enumerate(mod)]
        return fn(path, mod.detach())
    tree = ParamTree(plain(params, ()))
    grad = any(q.requires_grad for q in params.parameters())
    for p in tree.parameters():
        p.requires_grad_(grad)
        p.model_dim = None
    return tree


def shard_params(params, coords: dict, sizes: dict):
    """A full parameter ``ParamTree`` (``repro_torch.convert``'s layout)
    cut to the compute shards of the rank at ``coords`` (``{"model":
    m}``) of a mesh of ``sizes`` (``{"model": M, ...}``):
    :func:`compute_dim`'s dim of each leaf sliced (its :func:`split_range`
    share, recorded on the parameter, :func:`model_dim_of`), the rest
    copied."""
    m, msize = int(coords.get("model", 0)), int(sizes.get("model", 1))
    dims = {}

    def cut(path, t):
        d = compute_dim(path, tuple(t.shape), msize)
        if d is None:
            return t.clone()
        dims[".".join(path)] = d
        return t.narrow(d, *split_range(t.shape[d], msize, m)).contiguous()
    tree = _rebuild(params, cut)
    for name, p in tree.named_parameters():
        p.model_dim = dims.get(name)
    return tree


def gather_named(shards: list, like: dict) -> dict:
    """The model ranks' shards of named tensors (``{dotted name: tensor}``
    dicts, in model order: parameters, their gradients) joined into the
    whole tensors whose shapes ``like`` (``{dotted name: tensor}`` at the
    full size, e.g. ``named_parameters()`` of a full tree) gives."""
    msize = len(shards)
    out = {}
    for k, full in like.items():
        d = compute_dim(tuple(k.split(".")), tuple(full.shape), msize)
        parts = [s[k].detach() for s in shards]
        out[k] = parts[0].clone() if d is None else torch.cat(parts, dim=d)
    return out


def gather_params(shards: list, like):
    """The inverse of :func:`shard_params`: the model ranks' shard trees
    (in model order) as the full ``ParamTree`` shaped like ``like``."""
    whole = gather_named([dict(s.named_parameters()) for s in shards],
                         dict(like.named_parameters()))
    return _rebuild(like, lambda path, t: whole[".".join(path)])


# ---------------------------------------------------------------------------
# ZeRO-3 storage: the rule table's "data" entries (and the storage-only
# "model" entries) hold a rank's shares of parameters and optimizer state.
# ---------------------------------------------------------------------------
class Stored(NamedTuple):
    """How a rank of a ``(data, model)`` mesh holds a leaf of a stored
    state (:func:`store_state`): the whole leaf's shape, the dim a model
    rank computes on a share of (:func:`compute_dim`; None: whole), and
    the storage split: ``dim`` cut evenly over the mesh ``axes`` (major
    first; empty: the rank holds its compute shard), a share of the whole
    leaf (``of_leaf``: ``(("data", "model"), ...)`` entries, row-major
    ``d * M + m``, and a ``"model"`` entry on a leaf whole for compute)
    or of the rank's compute shard (a ``"data"`` entry)."""

    leaf: tuple
    model_dim: Optional[int]
    dim: Optional[int]
    axes: tuple
    of_leaf: bool
    coords: tuple           # (d, m)
    sizes: tuple            # (D, M)


def layout_of(path: tuple, shape: tuple, coords: dict,
              sizes: dict) -> Stored:
    """The :class:`Stored` layout of a parameter leaf (``path``: its
    dotted name split) on the rank at ``coords`` of a mesh of ``sizes``,
    from :func:`param_pspecs`' spec at those sizes: a ``"data"`` entry
    splits the compute shard, a ``("data", "model")`` entry the whole
    leaf over the grid, a ``"model"`` entry on a leaf whole for compute
    the whole leaf over the model group; an axis of size 1 splits
    nothing, and an axis that ``_pad_spec`` drops leaves the leaf whole
    on it."""
    shape = tuple(shape)
    ext = {"data": int(sizes.get("data", 1)),
           "model": int(sizes.get("model", 1))}
    spec = _pad_spec(_param_rule("/".join(path), path[-1], shape), shape,
                     ext)
    cdim = compute_dim(path, shape, ext["model"])
    dim, axes, of_leaf = None, (), False
    for d, ax in enumerate(spec):
        names = ax if isinstance(ax, tuple) else (ax,)
        if "data" in names:
            dim, axes, of_leaf = d, names, isinstance(ax, tuple)
            break
    else:
        if cdim is None:
            dim = next((d for d, ax in enumerate(spec) if ax == "model"),
                       None)
            axes, of_leaf = ("model",), True
    axes = tuple(a for a in axes if ext[a] > 1) if dim is not None else ()
    return Stored(shape, cdim, dim if axes else None, axes,
                  of_leaf and bool(axes),
                  (int(coords.get("data", 0)), int(coords.get("model", 0))),
                  (ext["data"], ext["model"]))


def stored_of(t: torch.Tensor) -> Optional[Stored]:
    """The :class:`Stored` layout recorded on a leaf of a stored state, or
    None."""
    return getattr(t, "stored", None)


def is_stored(params) -> bool:
    """Whether any parameter of ``params`` is held as a storage share."""
    return any(getattr(stored_of(p), "axes", ()) for p in params.parameters())


def _share(st: Stored) -> tuple:
    """``(index, parts)`` of the rank's share over the storage axes."""
    d, m = st.coords
    D, M = st.sizes
    idx = {("data",): (d, D), ("model",): (m, M),
           ("data", "model"): (d * M + m, D * M)}
    return idx[st.axes]


def compute_box(st: Stored) -> list:
    """``[(start, count)]`` per dim of the whole leaf: the rank's compute
    shard."""
    box = [(0, n) for n in st.leaf]
    if st.model_dim is not None and st.sizes[1] > 1:
        box[st.model_dim] = split_range(st.leaf[st.model_dim], st.sizes[1],
                                        st.coords[1])
    return box


def stored_box(st: Stored) -> list:
    """``[(start, count)]`` per dim of the whole leaf: the region the
    rank stores (its compute shard, or the whole leaf where the share is
    of it, cut by the storage split)."""
    box = [(0, n) for n in st.leaf] if st.of_leaf else compute_box(st)
    if st.axes:
        i, parts = _share(st)
        lo, n = box[st.dim]
        if n % parts:       # _pad_spec keeps only an axis that divides
            raise ValueError(f"{st}: dim {st.dim} does not split evenly")
        box[st.dim] = (lo + i * (n // parts), n // parts)
    return box


def _cut(t: torch.Tensor, box: list) -> torch.Tensor:
    for d, (lo, n) in enumerate(box):
        if (lo, n) != (0, t.shape[d]):
            t = t.narrow(d, lo, n)
    return t


def tag_layout(t: torch.Tensor, st: Stored) -> torch.Tensor:
    """Record the :class:`Stored` layout (and its ``model_dim``) on a
    leaf; returns it."""
    t.stored, t.model_dim = st, st.model_dim
    return t


def store_leaf(whole: torch.Tensor, st: Stored) -> torch.Tensor:
    """The rank's stored share of a whole leaf, its layout recorded."""
    return tag_layout(_cut(whole, stored_box(st)).contiguous().clone(), st)


_ST: Optional[tuple] = None     # (group, rank, size): the storage data group


@contextlib.contextmanager
def storage(group):
    """Make ``group`` (the rank's ``data`` subgroup of the mesh) the group
    a stored leaf's ``"data"`` split gathers over inside the block, whether
    or not the step's batch divides (its ``"model"`` split gathers over
    the active model group)."""
    global _ST
    prev = _ST
    if group is None:
        _ST = None
    else:
        import torch.distributed as dist
        _ST = (group, dist.get_rank(group), dist.get_world_size(group))
    try:
        yield
    finally:
        _ST = prev


def _group_of(axis: str, st: Stored) -> tuple:
    grp = _ST if axis == "data" else _MP
    want = st.sizes[0 if axis == "data" else 1]
    if grp is None or grp[2] != want:
        raise RuntimeError(f"a leaf stored over {st.axes} of a {st.sizes} "
                           f"mesh needs its {axis} group of {want} ranks "
                           f"(sharding.storage / model_parallel)")
    return grp


def gather_stored(x: torch.Tensor, st: Stored) -> torch.Tensor:
    """The rank's compute shard from its stored share (all_gathers over
    the storage axes, minor first; a share of the whole leaf then cut to
    the compute shard), outside autograd.  Any dtype: the int8 weight
    gather moves the 1-byte image."""
    if not st.axes:
        return x
    if x.numel() == 0:      # an empty compute shard: the group's all are
        shape = [n for _, n in compute_box(st)]
        return x.new_zeros(shape)
    for axis in reversed(st.axes):
        x = _all_gather(x, st.dim, grp=_group_of(axis, st))
    if st.of_leaf:
        x = _cut(x, compute_box(st))
    return x


def _reduce_scatter(x: torch.Tensor, dim: int, grp: tuple,
                    uneven: bool = False) -> torch.Tensor:
    """``x`` summed over ``grp``'s ranks, this rank's even share of
    ``dim`` kept (``reduce_scatter_tensor``, which gloo takes too);
    ``uneven``: its :func:`split_range` share, ``dim`` padded to ``M``
    shares of ``ceil(n / M)`` for the collective."""
    import warnings

    import torch.distributed as dist
    src = x.detach().movedim(dim, 0).contiguous()
    n, m = src.shape[0], grp[2]
    c = -(-n // m) if uneven else n // m
    if uneven and c * m > n:
        src = torch.cat([src, src.new_zeros((c * m - n,)
                                            + tuple(src.shape[1:]))])
    out = src.new_empty((c,) + tuple(src.shape[1:]))
    with warnings.catch_warnings():     # deprecated in newer releases
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=grp[0])
    if uneven:
        out = out[:split_range(n, m, grp[1])[1]]
    return out.movedim(0, dim).contiguous()


def scatter_stored(g: torch.Tensor, st: Stored) -> torch.Tensor:
    """The gradient of the rank's stored share from the gradient ``g`` of
    its compute shard, outside autograd: over the data axis summed and
    scattered (a reduce-scatter) where the step's batch is sharded
    (:func:`data_parallel`), else sliced (every rank holds the whole
    batch's gradient); over the model axis a share of the whole leaf's
    gradient, the model ranks' disjoint compute shards summed and
    scattered, or sliced where every model rank holds the leaf whole."""
    if not st.axes:
        return g
    g = g.to(torch.float32) if g.is_floating_point() else g
    embedded = st.of_leaf and st.model_dim is not None and st.sizes[1] > 1
    if g.numel() == 0 and not embedded:
        return g.new_zeros([n for _, n in stored_box(st)])
    if embedded:
        whole = g.new_zeros(st.leaf)
        _cut(whole, compute_box(st)).copy_(g)
        g = whole
    for axis in st.axes:
        grp = _group_of(axis, st)
        summed = (_DP is not None) if axis == "data" else embedded
        if summed:
            g = _reduce_scatter(g, st.dim, grp)
        else:
            c = g.shape[st.dim] // grp[2]
            g = g.narrow(st.dim, grp[1] * c, c).contiguous()
    return g


class _Unstore(torch.autograd.Function):
    """The compute shard gathered from the stored share; its gradient
    reduce-scattered back onto the share (:func:`scatter_stored`)."""

    @staticmethod
    def forward(ctx, x, st):
        ctx.st, ctx.dtype = st, x.dtype
        return gather_stored(x, st)

    @staticmethod
    def backward(ctx, g):
        return scatter_stored(g, ctx.st).to(ctx.dtype), None


def unstore(p: torch.Tensor) -> torch.Tensor:
    """A parameter as the layers read it: a stored share gathered into
    the rank's compute shard where it is used (the gradient
    reduce-scattered; under remat the recompute gathers again), any
    other tensor itself."""
    st = stored_of(p)
    if st is None or not st.axes:
        return p
    return _Unstore.apply(p, st)


def stored_minmax(mn: torch.Tensor, mx: torch.Tensor, st: Optional[Stored]):
    """The (min, max) of a stored leaf's share taken over its storage
    axes (one all_reduce MAX of ``(-min, max)`` an axis, exact)."""
    if st is None:
        return mn, mx
    for axis in st.axes:
        buf = torch.stack([-mn.to(torch.float32), mx.to(torch.float32)])
        buf = _all_reduce(buf, "max", _group_of(axis, st))
        mn, mx = (-buf[0]).to(mn.dtype), buf[1].to(mx.dtype)
    return mn, mx


def leaf_whole(t: torch.Tensor) -> torch.Tensor:
    """A leaf of a stored state gathered whole over its storage axes and
    its model split (collective: every rank of the mesh calls it, in the
    same order), outside autograd."""
    st = stored_of(t)
    if st is None:
        return t.detach()
    x = gather_stored(t.detach(), st)
    if st.model_dim is not None and st.sizes[1] > 1:
        x = _all_gather(x, st.model_dim, st.leaf[st.model_dim],
                        _group_of("model", st))
    return x


def _moments(opts: list, names, fn):
    """The first of the optimizer states ``opts`` (alike in structure)
    with ``fn(name, [tensor of each])`` at every tensor a dict keys by a
    parameter name (the moments); the rest kept."""
    first = opts[0]
    if not isinstance(first, dict):
        return first
    return {k: fn(k, [o[k] for o in opts])
            if k in names and isinstance(v, torch.Tensor)
            else _moments([o[k] for o in opts], names, fn)
            for k, v in first.items()}


def tag_moments(opt, named: dict):
    """Record each parameter's layout on the optimizer moments made for it
    (``zeros_like`` of the share keeps no attribute); returns ``opt``."""
    def tag(k, vs):
        st = stored_of(named[k])
        return vs[0] if st is None else tag_layout(vs[0], st)
    return _moments([opt], named, tag)


def store_params(params, coords: dict, sizes: dict):
    """A full parameter ``ParamTree`` cut to the stored shares of the rank
    at ``coords`` of a ``(data, model)`` mesh of ``sizes``
    (:func:`layout_of`; ZeRO-3), each with its :class:`Stored` layout and
    its ``model_dim`` recorded."""
    lay = {}

    def cut(path, t):
        st = lay[".".join(path)] = layout_of(path, tuple(t.shape), coords,
                                             sizes)
        return store_leaf(t, st)
    tree = _rebuild(params, cut)
    for name, p in tree.named_parameters():
        tag_layout(p, lay[name])
    return tree


def store_state(state: dict, coords: dict, sizes: dict) -> dict:
    """A whole train state (``runtime.steps``: params, optimizer state,
    quant, step) cut to the rank's stored state: the parameters by
    :func:`store_params`, the optimizer moments as their parameters, the
    quant state and the step whole."""
    params = store_params(state["params"], coords, sizes)
    named = dict(params.named_parameters())
    opt = _moments([state["opt"]], named,
                   lambda k, vs: store_leaf(vs[0], stored_of(named[k])))
    return {"params": params, "opt": opt, "quant": state["quant"],
            "step": state["step"]}


def _whole_of(pieces: list, lays: list) -> torch.Tensor:
    out = pieces[0].new_zeros(lays[0].leaf)
    for t, st in zip(pieces, lays):
        _cut(out, stored_box(st)).copy_(t)
    return out


def gather_state(states: list) -> dict:
    """The inverse of :func:`store_state` in one process: the stored
    states of every rank of the mesh (any order) joined into the whole
    state (parameters as a ``ParamTree`` without layouts)."""
    named = [dict(s["params"].named_parameters()) for s in states]
    lays = {k: [stored_of(n[k]) for n in named] for k in named[0]}
    params = _rebuild(states[0]["params"], lambda path, t: _whole_of(
        [n[".".join(path)].detach() for n in named], lays[".".join(path)]))
    opt = _moments([s["opt"] for s in states], named[0],
                   lambda k, vs: _whole_of(vs, lays[k]))
    return {"params": params, "opt": opt, "quant": states[0]["quant"],
            "step": states[0]["step"]}
