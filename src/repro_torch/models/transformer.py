"""The transformer stack (port of ``repro/models/transformer.py``): the
``"attn"`` block of the dense LMs (under the prefix-LM mask when the VLM
family's image prefix is set), the ``"moe"`` block of the MoE LMs
(the same attention, with :mod:`.moe` in place of the MLP), and the
hybrid family's ``"rec"`` (:mod:`.rglru` in place of the attention) and
``"local"`` (attention under a sliding mask of ``local_window``, its
cache a ring of that length) blocks, RWKV-6's ``"rwkv"`` block (the
:mod:`.rwkv6` time mix and channel mix, its cache the WKV state and the
two sublayers' last normed rows), and the enc-dec family's ``"enc"``
(bidirectional self-attention, RoPE kept) and ``"xattn"`` (causal
self-attention, then cross attention on the encoder's output, then the
MLP; its cache the self-attention's ``kv`` and the encoder's projections
``xkv``) blocks.

The reference scans a pattern unit with ``lax.scan`` and stacks per-layer
state into ``[repeats, ...]`` leaves, applying a ragged tail (e.g.
recurrentgemma's 38 = 12 x 3 + 2) unrolled; the port runs a Python loop
over the layers and keeps one entry per layer: params, quant sites and
caches are ``{"layers": [layer 0, layer 1, ...]}``, for the decoder and
the encoder alike.  ``repro_torch.convert`` maps between the two layouts.
Remat follows the reference's: one checkpoint a pattern unit (the
scanned ``jax.checkpoint``), the tail blocks unchecked.

Under a model group (``runtime.sharding.model_parallel``) every kind
runs on a rank's shards: the attention heads (where neither head dim
divides the group, its rows of the sequence or its padded share of the
heads), MLP columns, experts, the RG-LRU's channels and RWKV-6's heads
and ``d_ff``.  The caches are the reference's ``cache_pspecs``: a rank's
KV heads, else its slots of the cache length, else the whole k / v
cache (``pos`` its slots where the length divides), a ``rec`` block's
``h`` and ``conv`` of its channels, an ``rwkv`` block's ``state`` of its
heads; ``x_time`` and ``x_chan`` whole.  Under the sequence-parallel
residual (``sharding.seq_rows``) a block's input and output are the
rank's rows of the sequence, and each sublayer gathers its normed rows
(``runtime.sharding``'s module docstring).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime import sharding

from . import attention as attn
from . import layers
from . import moe as moe_mod
from . import rglru, rwkv6

# Seed stride reserved per layer (matches the reference).
_SEED_STRIDE = 64
_KINDS = ("attn", "moe", "local", "rec", "rwkv", "enc", "xattn")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def _init_block(gen: torch.Generator, kind: str, cfg) -> dict:
    _check_kind(kind)
    dt = getattr(torch, cfg.param_dtype)
    dev = gen.device
    p = {"ln1": layers.init_norm(cfg.d_model, cfg.norm_kind, cfg.use_bias,
                                 dev)}
    if kind == "rwkv":
        p["time"] = rwkv6.init_rwkv_time_mix(gen, cfg.d_model, cfg.n_heads,
                                             dtype=dt)
        p["ln2"] = layers.init_norm(cfg.d_model, cfg.norm_kind, cfg.use_bias,
                                    dev)
        p["chan"] = rwkv6.init_rwkv_channel_mix(gen, cfg.d_model, cfg.d_ff,
                                                dt)
        return p
    if kind == "rec":
        p["rglru"] = rglru.init_rglru(gen, cfg.d_model, cfg.lru_width, dt)
    else:
        p["attn"] = attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv, cfg.head_dim, cfg.use_bias,
                                        dt)
    if kind == "xattn":
        p["lnx"] = layers.init_norm(cfg.d_model, cfg.norm_kind, cfg.use_bias,
                                    dev)
        p["xattn"] = attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv, cfg.head_dim,
                                         cfg.use_bias, dt)
    p["ln2"] = layers.init_norm(cfg.d_model, cfg.norm_kind, cfg.use_bias,
                                dev)
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg.d_model, cfg.moe, dt)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                                   cfg.use_bias, dt)
    return p


def _init_block_sites(kind: str, cfg, device=None) -> dict:
    _check_kind(kind)
    if kind == "moe":
        return {"attn": attn.init_attention_sites(device),
                "moe": moe_mod.init_moe_sites(cfg.moe, device)}
    if kind == "rwkv":
        return {"time": rwkv6.init_rwkv_time_sites(device),
                "chan": rwkv6.init_rwkv_channel_sites(device)}
    if kind == "rec":
        return {"rglru": rglru.init_rglru_sites(device),
                "mlp": layers.init_mlp_sites(cfg.mlp_kind, device)}
    sites = {"attn": attn.init_attention_sites(device)}
    if kind == "xattn":
        sites["xattn"] = attn.init_attention_sites(device)
    sites["mlp"] = layers.init_mlp_sites(cfg.mlp_kind, device)
    return sites


def _model_share(n: int, what: str) -> int:
    """A model rank's share of ``n`` (``n`` without a model group)."""
    mp = sharding.mp_shard()
    if mp is None:
        return n
    if n % mp[1]:
        raise ValueError(f"{what} {n} does not split over {mp[1]} model "
                         f"ranks")
    return n // mp[1]


def _init_block_cache(kind: str, cfg, batch: int, cache_len: int,
                      device=None) -> dict:
    _check_kind(kind)
    cdt = getattr(torch, cfg.cache_dtype)
    if kind == "rwkv":
        hd = cfg.d_model // cfg.n_heads
        heads = _model_share(cfg.n_heads, "rwkv heads")
        return {"state": torch.zeros((batch, heads, hd, hd),
                                     dtype=torch.float32, device=device),
                "x_time": torch.zeros((batch, cfg.d_model), dtype=cdt,
                                      device=device),
                "x_chan": torch.zeros((batch, cfg.d_model), dtype=cdt,
                                      device=device)}
    if kind == "rec":
        width = _model_share(cfg.lru_width, "lru_width")
        return {"h": torch.zeros((batch, width), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, 3, width), dtype=cdt,
                                    device=device)}
    length = cache_len
    if kind == "local":
        length = min(cache_len, cfg.local_window)
    elif cfg.sliding_window is not None and kind != "xattn":
        length = min(cache_len, cfg.sliding_window)
    # a model rank's slice of the cache (cache_pspecs' k/v and pos rules)
    cache = {"kv": attn.init_kv_cache(batch, length, cfg.n_kv, cfg.head_dim,
                                      cdt, device)}
    if kind == "xattn":
        # the encoder's projections; a longer source keeps its last slots
        cache["xkv"] = attn.init_kv_cache(batch, cfg.enc_len(cache_len),
                                          cfg.n_kv, cfg.head_dim, cdt,
                                          device)
    return cache


def _whole(h: torch.Tensor, seq_len) -> torch.Tensor:
    """A sublayer's normed input: under the sequence-parallel residual
    (``seq_len`` the whole length) the ranks' rows gathered, in the
    compute dtype (the gradient keeps this rank's rows)."""
    return h if seq_len is None else sharding.mp_gather(h, 1, seq_len)


def _apply_rec_block(params, sites, x, *, cfg, policy, seed, step,
                     cache=None, seq_len=None):
    """The ``"rec"`` block: the RG-LRU in the attention's place.  A cache's
    (zero) state enters a prefill as the reference passes it."""
    new_sites: dict = {}
    sd = None if seq_len is None else 1
    h = _whole(layers.apply_norm(x, params["ln1"], cfg.norm_kind), seq_len)
    st = None if cache is None else (cache["h"],
                                     cache["conv"].to(h.dtype))
    a, new_sites["rglru"], (hstate, tail) = rglru.apply_rglru(
        params["rglru"], sites["rglru"], h, policy=policy, seed=seed,
        step=step, state=st, seq_dim=sd)
    x = x + a
    h = _whole(layers.apply_norm(x, params["ln2"], cfg.norm_kind), seq_len)
    m, new_sites["mlp"] = layers.apply_mlp(params["mlp"], sites["mlp"], h,
                                           cfg.mlp_kind, policy, seed + 16,
                                           step, seq_dim=sd)
    x = x + m
    new_cache = None if cache is None else {
        "h": hstate, "conv": tail.to(cache["conv"].dtype)}
    return x, new_sites, new_cache, None


def _apply_rwkv_block(params, sites, x, *, cfg, policy, seed, step,
                      cache=None, seq_len=None):
    """The ``"rwkv"`` block: time mix (seeds ``seed + 0..4``) and channel
    mix (``seed + 16..18``), each after its norm.  The cache keeps the
    WKV state and each sublayer's last *normed* input row (in the cache
    dtype, cast back to the compute dtype on the way in)."""
    new_sites: dict = {}
    sd = None if seq_len is None else 1
    h = _whole(layers.apply_norm(x, params["ln1"], cfg.norm_kind), seq_len)
    st = None if cache is None else cache["state"]
    xp = None if cache is None else cache["x_time"].to(h.dtype)
    a, new_sites["time"], (st, x_last) = rwkv6.rwkv_time_mix(
        params["time"], sites["time"], h, n_heads=cfg.n_heads, policy=policy,
        seed=seed, step=step, chunk=cfg.rwkv_chunk, state=st, x_prev=xp,
        seq_dim=sd)
    x = x + a
    h = _whole(layers.apply_norm(x, params["ln2"], cfg.norm_kind), seq_len)
    xp = None if cache is None else cache["x_chan"].to(h.dtype)
    c, new_sites["chan"], c_last = rwkv6.rwkv_channel_mix(
        params["chan"], sites["chan"], h, policy=policy, seed=seed + 16,
        step=step, x_prev=xp, seq_dim=sd)
    x = x + c
    # copies: a view of the last row would keep the whole [B, S, D]
    # normed input alive in the cache
    new_cache = None if cache is None else {
        "state": st,
        "x_time": x_last.to(cache["x_time"].dtype, copy=True),
        "x_chan": c_last.to(cache["x_chan"].dtype, copy=True)}
    return x, new_sites, new_cache, None


def _apply_block(kind: str, params, sites, x, *, cfg, policy, seed, step,
                 positions, cache=None, enc_out=None, enc_len=None,
                 prefix_len=None, seq_len=None):
    """Returns ``(x, stats, cache, metrics)``: the MoE block's
    ``{aux_loss, z_loss}``, ``None`` for the others.  ``enc_out`` /
    ``enc_len`` feed an ``"xattn"`` block's cross attention (``None`` in
    decode: it reads its ``xkv`` cache); ``prefix_len`` puts ``"attn"``
    and ``"moe"`` blocks under the prefix-LM mask.  ``seq_len``: ``x`` is
    the rank's rows of a sequence of that length (the sequence-parallel
    residual), and so is the block's output."""
    _check_kind(kind)
    if kind == "rwkv":
        return _apply_rwkv_block(params, sites, x, cfg=cfg, policy=policy,
                                 seed=seed, step=step, cache=cache,
                                 seq_len=seq_len)
    if kind == "rec":
        return _apply_rec_block(params, sites, x, cfg=cfg, policy=policy,
                                seed=seed, step=step, cache=cache,
                                seq_len=seq_len)
    sd = None if seq_len is None else 1
    window = cfg.local_window if kind == "local" else cfg.sliding_window
    mode = "sliding" if window is not None else "causal"
    if kind == "enc":
        mode = "sliding" if window is not None else "bidir"
    if prefix_len is not None and kind in ("attn", "moe"):
        mode = "prefix"
    new_sites: dict = {}
    new_cache = None if cache is None else {}
    h = layers.apply_norm(x, params["ln1"], cfg.norm_kind)
    a, new_sites["attn"], kv = attn.attention_layer(
        params["attn"], sites["attn"], h, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv, head_dim=cfg.head_dim, mode=mode, window=window,
        prefix_len=prefix_len, rope_theta=cfg.rope_theta,
        positions=positions, cache=None if cache is None else cache["kv"],
        policy=policy, seed=seed, step=step, q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk, dense_attn_max=cfg.dense_attn_max,
        seq_len=seq_len)
    x = x + a
    if cache is not None:
        new_cache["kv"] = kv
    if kind == "xattn":
        h = layers.apply_norm(x, params["lnx"], cfg.norm_kind)
        a, new_sites["xattn"], xkv = attn.attention_layer(
            params["xattn"], sites["xattn"], h, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv, head_dim=cfg.head_dim, mode="cross",
            rope_theta=None, positions=positions, kv_x=enc_out,
            kv_len=enc_len, cache=None if cache is None else cache["xkv"],
            policy=policy, seed=seed + 8, step=step, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk, seq_len=seq_len)
        x = x + a
        if cache is not None:
            new_cache["xkv"] = xkv
    h = _whole(layers.apply_norm(x, params["ln2"], cfg.norm_kind), seq_len)
    if kind == "moe":
        m, new_sites["moe"], metrics = moe_mod.apply_moe(
            params["moe"], sites["moe"], h, cfg.moe, policy=policy,
            seed=seed + 16, step=step, seq_dim=sd)
    else:
        m, new_sites["mlp"] = layers.apply_mlp(params["mlp"], sites["mlp"],
                                               h, cfg.mlp_kind, policy,
                                               seed + 16, step, seq_dim=sd)
        metrics = None
    x = x + m
    return x, new_sites, new_cache, metrics


def _kinds(pattern, n_layers: int) -> list:
    return [pattern[i % len(pattern)] for i in range(n_layers)]


def stack_depth(cfg, pattern) -> int:
    """The layers of the stack of ``pattern``: the encoder's ``enc_layers``
    (enc-dec), else ``n_layers``."""
    if cfg.family == "encdec" and pattern == cfg.enc_pattern:
        return cfg.enc_layers
    return cfg.n_layers


def init_stack(gen: torch.Generator, cfg, pattern, n_layers: int) -> dict:
    return {"layers": [_init_block(gen, kind, cfg)
                       for kind in _kinds(pattern, n_layers)]}


def init_stack_sites(cfg, pattern, n_layers: int, device=None) -> dict:
    return {"layers": [_init_block_sites(kind, cfg, device)
                       for kind in _kinds(pattern, n_layers)]}


def init_stack_cache(cfg, pattern, n_layers: int, batch: int,
                     cache_len: int, device=None) -> dict:
    return {"layers": [_init_block_cache(kind, cfg, batch, cache_len, device)
                       for kind in _kinds(pattern, n_layers)]}


def apply_stack(params, sites, x, *, cfg, pattern, policy, seed, step,
                positions, caches=None, enc_out=None, enc_len=None,
                prefix_len=None):
    """Returns ``(x, stats, caches, metrics)``, the blocks' ``aux_loss``
    and ``z_loss`` summed over the layers; the stack of ``pattern`` has
    :func:`stack_depth` layers: ``depth // len(pattern)`` pattern units,
    then the tail's ``depth % len(pattern)`` blocks.  With ``cfg.remat``
    and a recorded gradient each unit is one checkpoint (its blocks'
    activations are recomputed in the backward pass, only its input is
    saved) and the tail blocks run unchecked, as the reference's
    ``jax.checkpoint`` of the scan unit and its unrolled tail.

    Under the sequence-parallel residual (``sharding.seq_rows``) ``x`` is
    the rank's ``sharding.split_range`` rows of the ``positions.shape[1]``
    rows of the sequence, at every block boundary (so a checkpoint saves
    the rank's rows), and so is the output."""
    seq_len = positions.shape[1] if sharding.seq_rows() else None
    remat = cfg.remat and torch.is_grad_enabled()
    kinds = _kinds(pattern, stack_depth(cfg, pattern))
    unit = len(pattern)
    new_sites, new_caches = [], []
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    metrics = {"aux_loss": zero, "z_loss": zero}

    def blocks(lo, hi, x):
        outs = []
        for idx in range(lo, hi):
            x, ns, nc, met = _apply_block(
                kinds[idx], params["layers"][idx], sites["layers"][idx], x,
                cfg=cfg, policy=policy, seed=seed + idx * _SEED_STRIDE,
                step=step, positions=positions,
                cache=None if caches is None else caches["layers"][idx],
                enc_out=enc_out, enc_len=enc_len, prefix_len=prefix_len,
                seq_len=seq_len)
            outs.append((ns, nc, met))
        return x, outs

    tail = len(kinds) - len(kinds) % unit
    for lo in range(0, len(kinds), unit):
        hi = min(lo + unit, len(kinds))
        if lo < tail:       # a pattern unit
            x = sharding.hint(x, "batch", "seq", "embed")
        if lo < tail and remat:
            x, outs = checkpoint(functools.partial(blocks, lo, hi), x,
                                 use_reentrant=False)
        else:
            # block by block: a unit's input is not held past its block
            outs = []
            for idx in range(lo, hi):
                x, out = blocks(idx, idx + 1, x)
                outs += out
        for ns, nc, met in outs:
            new_sites.append(ns)
            new_caches.append(nc)
            if met is not None:
                metrics = {k: metrics[k] + met[k] for k in metrics}
    return (x, {"layers": new_sites},
            None if caches is None else {"layers": new_caches}, metrics)
