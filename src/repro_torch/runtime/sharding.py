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
entries at the production model size); leaves whose ``model`` entry is
a storage split only, ``(("data", "model"), ...)``, stay replicated
over ``model`` (``wq`` / ``wo`` / ``bq`` hold their padded head shares
for compute), as do ``patch_proj`` / ``enc_in`` (ZeRO-3, ROADMAP.md
§1).

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
from typing import Any, Optional

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


def _all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """A copy of ``x`` reduced (``"sum"`` / ``"max"``) over the active
    model group, outside autograd."""
    import torch.distributed as dist
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, op.upper()), group=_MP[0])
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


def _all_gather(x: torch.Tensor, dim: int,
                total: Optional[int] = None) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim``, outside
    autograd.  ``total``: the whole size of ``dim``, whose shares
    (:func:`split_range`) may differ between ranks: each is padded to
    ``ceil(total / M)`` for the collective and the padding dropped."""
    import torch.distributed as dist
    x = x.detach().contiguous()
    if total is not None:
        dim = dim % x.dim()
        c = -(-total // _MP[2])
        if x.shape[dim] < c:
            pad = list(x.shape)
            pad[dim] = c - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(x) for _ in range(_MP[2])]
    dist.all_gather(parts, x, group=_MP[0])
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
    stay whole, as the reference's rule table leaves them).  Raises
    where a rule's dim does not divide ``msize`` (a padded head dim
    excepted)."""
    if msize == 1:
        return None
    name = path[-1]
    dim, padded = None, False
    block = next((b for b in _BLOCK_DIMS if b in path), None)
    if block is not None:
        dim = _BLOCK_DIMS[block].get(name)
    elif name == "embed":
        dim = 0
    elif name == "head":
        dim = 1
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
        dim = 0
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
