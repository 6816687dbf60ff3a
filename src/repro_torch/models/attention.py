"""Attention (port of ``repro/models/attention.py``): GQA self-attention
with quantized q/k/v/o projections, the backend-dispatched int8 attention
core for static policies, the fp paths, and the KV cache.

Layouts follow the reference: ``wq [D, KV, G, hd]``, ``wo [KV, G, hd, D]``,
activations ``q [B, S, KV, G, hd]``, ``k/v [B, S, KV, hd]``; caches are
dicts ``{"k": [B, L, KV, hd], "v": ..., "pos": [B, L]}`` (sliding-window
caches are ring buffers).  Unlike the reference's functional updates, the
cache functions write into the cache tensors in place (a full-size cache
copy per layer and token would double its memory), and return the dict.

The fp paths of non-static policies (fp32, the dynamic estimators,
``grad_only``) follow the reference's dispatch: ``_dense_attn`` (one
score tile) up to ``dense_attn_max``, ``_local_attn`` (each block of
``window`` queries against its own and the previous kv block) past a
sliding window, and ``_chunked_attn`` (online softmax over ``q_chunk`` x
``kv_chunk`` blocks) otherwise.  Without a recorded gradient they update
their score tiles in place (the same values, one tile's memory).

Cross attention (the enc-dec family) takes its keys and values from
``kv_x``, the encoder's output, with an activation site of its own on the
``k`` site and no RoPE; a prefill fills the cross cache with the encoder's
projections, and decode (``kv_x=None``) attends that cache whole without
running a k/v projection.

Under a model group (``runtime.sharding.model_parallel``) a rank holds
the heads :func:`local_heads` gives (``sharding.attn_layout``: the KV
heads where KV divides the group, else the G query heads of every KV
head) and the layer runs on them: q (and k, v when KV is sharded) are
column-parallel products, the core (the int8 kernel or an fp path) holds
the rank's heads, and the output projection is row-parallel.  Where G is
sharded, k and v are computed whole on every rank, and their cotangent,
each rank's partial over its G heads, is summed (in fp32 inside the int8
core's backward) before their gradient sites quantize it.

Where neither head dim divides the group, the layer's dense-path
predicate holds (``allow_seq``: the reference's ``will_use_dense``, no
cache, not the local or chunked path, S > 1) and the group divides S,
the layer runs the reference's sequence-parallel core (layout
``"seq"``): the weights are whole on every rank (``wq`` / ``wo`` /
``bq`` gathered from their head shards), each rank takes its ``S / M``
rows of the normed input, projects q, k and v on them, rotates them at
their own positions, gathers k and v along S (in fp: the core's k and v
sites then quantize the whole tensors, as one process does, at twice
the bytes of their int8 images), runs the core on its q rows against the
whole keys (the kernel's query offset) and the ``o`` projection on its
rows, and gathers the output for the replicated residual stream.  The k
/ v cotangents (each rank's partial) are summed in fp32 before their
sites, and the weights' gradients, partial sums over a rank's rows, are
summed over the group and each rank keeps its heads' share.

Elsewhere (decode, a prefill that fills a cache, the local path and the
sliding int8 core past a window, the chunked path) the layer runs the
reference's third layout, padded head sharding (``"g_pad"``, or
``"kv_pad"`` where KV > G): each rank holds its
``sharding.split_range`` share of the padded head dim, possibly fewer
heads than the others or none, and runs the ``"g"`` (or ``"kv"``)
layout's pairs on it.  Under ``"kv_pad"`` k and v are computed whole and
sliced to the rank's KV heads (their cotangent gathered).  A rank with
no heads launches no kernel and still takes part in every collective
(its ``o`` partial is zeros, its k / v cotangent too).

The decode cache follows the reference's ``cache_pspecs``
(:func:`init_kv_cache`): a rank holds its KV heads where KV divides the
group, else its slots ``[r L / M, (r + 1) L / M)`` of the cache length
where the group divides L (a ring's slot ``pos % L`` too), else the
whole cache; ``pos`` holds the rank's slots wherever L divides.  A
prefill writes the slots a rank owns, a decode step's token only on its
owner.  Decode over a length shard (:func:`_decode_attn`) gathers the
group's q heads, scores them against the rank's slots, takes the exact
max over the group and sums the numerator and denominator partials over
it in rank order; each rank keeps its own heads' rows for ``o``.  All
of it runs in fp32, as the one-process decode does: the split of L
reassociates the sums over it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import backend, qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import init_range_state, make_range_state
from repro_torch.runtime import sharding

from .layers import apply_rope, init_normal

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# The model axis.
# ---------------------------------------------------------------------------
def local_heads(n_kv: int, g: int):
    """``(kv, g, layout)``: the KV and G head counts a model rank holds
    where no sequence-parallel core applies, and the layout (``"kv"`` /
    ``"g"`` / ``"kv_pad"`` / ``"g_pad"``; None without a model group).
    A padded dim's count is the rank's ``sharding.split_range`` share."""
    mp = sharding.mp_shard()
    if mp is None:
        return n_kv, g, None
    r, m = mp
    layout = sharding.attn_layout(n_kv, g, m)
    if layout.startswith("kv"):
        return sharding.split_range(n_kv, m, r)[1], g, layout
    return n_kv, sharding.split_range(g, m, r)[1], layout


# ---------------------------------------------------------------------------
# Parameter / site init.
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, use_bias: bool,
                   dtype=torch.float32) -> dict:
    s = d_model ** -0.5
    g = n_heads // n_kv
    p = {
        "wq": init_normal(gen, (d_model, n_kv, g, head_dim), s, dtype),
        "wk": init_normal(gen, (d_model, n_kv, head_dim), s, dtype),
        "wv": init_normal(gen, (d_model, n_kv, head_dim), s, dtype),
        "wo": init_normal(gen, (n_kv, g, head_dim, d_model),
                      (n_heads * head_dim) ** -0.5, dtype),
    }
    if use_bias:
        dev = gen.device
        p["bq"] = torch.zeros((n_kv, g, head_dim), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv, head_dim), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv, head_dim), dtype=dtype, device=dev)
        p["bo"] = torch.zeros((d_model,), dtype=dtype, device=dev)
    return p


def init_attention_sites(device=None) -> dict:
    sites = {name: qlinear.init_site(device=device)
             for name in ("q", "k", "v", "o")}
    # The attention core's sites; the probability leaf starts at the
    # softmax codomain [0, 1] (its range is consumed mid-kernel).
    sites["core"] = {
        "q": {"act": init_range_state(device=device)},
        "k": {"act": init_range_state(device=device)},
        "v": {"act": init_range_state(device=device)},
        "p": {"act": make_range_state(0.0, 1.0, device=device)},
    }
    return sites


# ---------------------------------------------------------------------------
# Masks and the fp attention paths.
# ---------------------------------------------------------------------------
def _mask_block(q_pos, kv_pos, mode: str, window: Optional[int],
                prefix_len: Optional[int], kv_len):
    """Boolean ``[q, k]`` mask: True = attend."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    if mode in ("cross", "bidir"):
        m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                       device=q_pos.device)
    elif mode == "prefix":
        m = (k <= q) | (k < prefix_len)
    elif mode == "sliding":
        m = (k <= q) & (q - k < window)
    else:
        m = k <= q
    if kv_len is not None:
        m = m & (k < kv_len)
    return m


def _softmax_numerator(s, keep):
    """``exp(where(keep, s, NEG_INF) - rowmax)``; in place on ``s`` when no
    gradient is recorded."""
    if torch.is_grad_enabled():
        s = torch.where(keep, s, NEG_INF)
        return torch.exp(s - s.amax(dim=-1, keepdim=True))
    s.masked_fill_(~keep, NEG_INF)
    return s.sub_(s.amax(dim=-1, keepdim=True)).exp_()


def _dense_attn(q, k, v, *, mode: str, window, prefix_len, kv_len,
                scale: float, q_start: int = 0):
    """Single-tile fp32 attention (S <= ``dense_attn_max``); q's rows are
    at the positions from ``q_start`` (the sequence-parallel core's)."""
    sq, skv = q.shape[1], k.shape[1]
    s = torch.einsum("bqngh,bknh->bngqk", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    dev = q.device
    mask = _mask_block(q_start + torch.arange(sq, device=dev),
                       torch.arange(skv, device=dev), mode, window,
                       prefix_len, kv_len)
    p = _softmax_numerator(s, mask)
    out = torch.einsum("bngqk,bknh->bngqh", p, v.to(torch.float32))
    out = out / p.sum(dim=-1).clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _chunked_attn(q, k, v, *, mode: str, window, prefix_len, kv_len,
                  q_start: int, q_chunk: int, kv_chunk: int, scale: float):
    """Online-softmax attention over ``q_chunk`` x ``kv_chunk`` blocks
    (fp32 running ``m``, ``l`` and accumulator), the reference's order:
    each q block walks every kv block (masked blocks included), and the
    divide comes last.  q ``[B, Sq, KV, G, hd]`` at absolute positions
    from ``q_start``; k/v ``[B, Skv, KV, hd]``."""
    b, sq, nkv, g, hd = q.shape
    skv = k.shape[1]
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % qc or skv % kc:
        raise ValueError(f"chunks ({qc}, {kc}) must divide the sequence "
                         f"lengths ({sq}, {skv})")
    dev, f32 = q.device, torch.float32
    outs = []
    for q0 in range(0, sq, qc):
        qblk = q[:, q0:q0 + qc].to(f32) * scale
        q_pos = q_start + q0 + torch.arange(qc, device=dev)
        m = torch.full((b, nkv, g, qc), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, nkv, g, qc), dtype=f32, device=dev)
        acc = torch.zeros((b, nkv, g, qc, hd), dtype=f32, device=dev)
        for k0 in range(0, skv, kc):
            s = torch.einsum("bqngh,bknh->bngqk", qblk,
                             k[:, k0:k0 + kc].to(f32))
            mask = _mask_block(q_pos, k0 + torch.arange(kc, device=dev),
                               mode, window, prefix_len, kv_len)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bngqk,bknh->bngqh", p, v[:, k0:k0 + kc].to(f32))
            m = m_new
        out = acc / l.clamp(min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1).to(q.dtype)


def _local_attn(q, k, v, *, window: int, scale: float):
    """Block-local sliding-window attention (S a multiple of ``window``):
    each block of ``window`` queries attends its own kv block and the one
    before it, all blocks in one batch, O(S * 2 window) work; block 0's
    first half (no previous block) is masked."""
    b, s, nkv, g, hd = q.shape
    if s % window:
        raise ValueError(f"sequence {s} is not a multiple of window "
                         f"{window}")
    nblk, w, dev = s // window, window, q.device
    qb = q.reshape(b, nblk, w, nkv, g, hd).to(torch.float32) * scale
    kb = k.reshape(b, nblk, w, nkv, hd).to(torch.float32)
    vb = v.reshape(b, nblk, w, nkv, hd).to(torch.float32)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1),
                    kb], dim=2)                         # [B, nblk, 2w, KV, hd]
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1),
                    vb], dim=2)
    del kb, vb
    s_ = torch.einsum("bnqkgh,bnmkh->bnkgqm", qb, k2)   # [B, nblk, KV, G, w, 2w]
    qpos = torch.arange(w, device=dev)[:, None]
    kpos = torch.arange(2 * w, device=dev)[None, :] - w
    valid = (kpos <= qpos) & (qpos - kpos < w)
    blk = torch.arange(nblk, device=dev)[:, None, None]
    valid = valid[None] & ((blk > 0) | (kpos >= 0))    # [nblk, w, 2w]
    p = _softmax_numerator(s_, valid[:, None, None])
    den = p.sum(dim=-1).clamp(min=1e-30)[..., None].permute(0, 1, 4, 2, 3, 5)
    out = torch.einsum("bnkgqm,bnmkh->bnqkgh", p, v2) / den
    return out.reshape(b, s, nkv, g, hd).to(q.dtype)


def _decode_attn(q, k_cache, v_cache, cache_pos, cur_pos, *, mode: str,
                 window, prefix_len, scale: float, kv_scale=None,
                 group: bool = False):
    """One new token against the cache.  q ``[B, 1, KV, G, hd]``; caches
    ``[B, L, KV, hd]``; ``cache_pos [B, L]`` (-1 = empty slot); ``cur_pos
    [B]``.  ``kv_scale`` = (k_scale, v_scale) of an int8 cache, folded
    into the epilogue.  ``group``: the caches are this model rank's slots
    of a length-sharded cache; the max is taken over the group (exact)
    and the numerator and denominator partials summed over it in rank
    order.  The sums over L are ``backend.in_blocks``' (one call but
    under a floor measurement's ``backend.reassociate``)."""
    qf = q[:, 0].to(torch.float32) * scale
    if kv_scale is not None:
        qf = qf * kv_scale[0]
    s = torch.einsum("bkgh,blkh->bkgl", qf, k_cache.to(torch.float32))
    pos = cache_pos[:, None, None, :]
    cur = cur_pos[:, None, None, None]
    valid = (pos >= 0) & (pos <= cur)
    if mode == "sliding":
        valid &= (cur - pos) < window
    if mode == "prefix":
        valid |= (pos >= 0) & (pos < prefix_len)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if group:
        m = sharding.mp_max(m)
    p = torch.exp(s - m)
    vf = v_cache.to(torch.float32)
    out = backend.in_blocks(lambda lo, n: torch.einsum(
        "bkgl,blkh->bkgh", p.narrow(-1, lo, n), vf.narrow(1, lo, n)),
        p.shape[-1])
    den = backend.in_blocks(lambda lo, n: p.narrow(-1, lo, n).sum(dim=-1),
                            p.shape[-1])
    if group:
        both = sharding.mp_sum_ordered(torch.cat([out, den[..., None]], -1))
        out, den = both[..., :-1], both[..., -1]
    out = out / den.clamp(min=1e-30)[..., None]
    if kv_scale is not None:
        out = out * kv_scale[1]
    return out[:, None].to(q.dtype)


def _decode_cached(q, cache: dict, cur, heads, **kw):
    """:func:`_decode_attn` of q (a rank's heads: ``heads`` = ``(dim,
    whole size)`` of its head dim, None when whole) against a cache laid
    out as :func:`init_kv_cache` lays it: a length shard's group softmax
    on the group's q heads gathered, then the rank's own heads kept; a
    position cache sharded beside head-sharded k / v gathered; a whole
    cache's KV heads sliced to a ``"kv_pad"`` rank's."""
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
    kw["kv_scale"] = cache.get("scale")
    split = sharding.cache_split_of(kc)
    if split is not None and split[0] == 1:
        qa = q if heads is None else sharding.mp_gather(q, *heads)
        out = _decode_attn(qa, kc, vc, pc, cur, group=True, **kw)
        return out if heads is None else sharding.mp_slice(out, heads[0])
    if sharding.cache_split_of(pc) is not None:
        pc = sharding.mp_gather(pc, 1)
    if heads is not None and heads[0] == 2 and split is None:
        kc, vc = sharding.mp_slice(kc, 2), sharding.mp_slice(vc, 2)
    return _decode_attn(q, kc, vc, pc, cur, **kw)


# ---------------------------------------------------------------------------
# KV cache.
# ---------------------------------------------------------------------------
def init_kv_cache(batch: int, length: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """int8 dtype = the in-hindsight quantized cache: per-tensor symmetric
    scales set at prefill, folded into the decode epilogue.  Under a
    model group a rank holds the slice ``sharding.cache_pspecs`` gives
    (``sharding.kv_cache_split``, ``pos_cache_split``) of the whole
    cache's ``length`` and ``n_kv`` heads, recorded on the tensor
    (``sharding.cache_split_of``); the scales stay whole."""
    mp = sharding.mp_shard()
    whole = (batch, length, n_kv, head_dim)
    kv_d = pos_d = None
    shape = list(whole)
    if mp is not None:
        kv_d = sharding.kv_cache_split(n_kv, length, mp[1])
        pos_d = sharding.pos_cache_split(length, mp[1])
        if kv_d is not None:
            shape[kv_d] //= mp[1]
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device),
         "pos": torch.full((batch, length // mp[1] if pos_d else length),
                           -1, dtype=torch.int32, device=device)}
    if kv_d is not None:
        c["k"].model_split = c["v"].model_split = (kv_d, whole[kv_d])
    if pos_d is not None:
        c["pos"].model_split = (pos_d, length)
    if dtype == torch.int8:
        c["scale"] = torch.ones((2,), dtype=torch.float32, device=device)
    return c


def _cache_length(cache: dict) -> int:
    """The whole cache's length (a rank may hold a slice of it)."""
    split = sharding.cache_split_of(cache["pos"])
    return cache["pos"].shape[1] if split is None else split[1]


def _own_range(t: torch.Tensor):
    """``(first, count)`` of the whole cache's slots a length shard ``t``
    holds, or None (it holds them all)."""
    split = sharding.cache_split_of(t)
    if split is None or split[0] != 1:
        return None
    r, m = sharding.mp_shard()
    return sharding.split_range(split[1], m, r)


def _owned_positions(start: int, s: int, length: int, lo: int, n: int,
                     device) -> torch.Tensor:
    """The indices ``i`` into the positions ``[start, s)`` whose slot
    ``(start + i) % length`` a length shard owns (``[lo, lo + n)``), in
    order: an index of static shape, the elements a mask selects.  The
    positions cover the ring at most once, so their slots are two runs
    (up to the ring's end, then from 0) and the owned ones at most two
    ranges."""
    a, count = start % length, s - start
    parts = []
    for u, v, off in ((a, min(a + count, length), 0),
                      (0, a + count - length, length - a)):
        first, end = max(u, lo), min(v, lo + n)
        if end > first:
            parts.append(torch.arange(first - u + off, end - u + off,
                                      device=device))
    if not parts:
        return torch.zeros(0, dtype=torch.long, device=device)
    return torch.cat(parts)


def _quant_kv(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(x.to(torch.float32) / scale).clamp(-127, 127).to(
        torch.int8)


def cache_fill(cache: dict, k, v) -> dict:
    """Prefill: write ``[B, S, KV, hd]`` into the cache in place.  Ring
    caches (L < S) keep the last L tokens at slots ``pos % L``; a length
    shard writes the slots it owns."""
    s = k.shape[1]
    length = _cache_length(cache)
    start = max(0, s - length)
    pos = torch.arange(start, s, device=k.device)
    slots = pos % length
    ksrc, vsrc = k[:, start:], v[:, start:]
    if "scale" in cache:
        # the whole cache's scales: a model rank holds some heads
        ks = (sharding.mp_max(ksrc.to(torch.float32).abs().amax())
              / 127.0).clamp(min=1e-8)
        vs = (sharding.mp_max(vsrc.to(torch.float32).abs().amax())
              / 127.0).clamp(min=1e-8)
        cache["scale"] = torch.stack([ks, vs])
        ksrc, vsrc = _quant_kv(ksrc, ks), _quant_kv(vsrc, vs)
    for name, src in (("k", ksrc), ("v", vsrc), ("pos", pos[None])):
        t = cache[name]
        own = _own_range(t)
        if own is None:
            t[:, slots] = src.to(t.dtype)
            continue
        keep = _owned_positions(start, s, length, *own, k.device)
        t[:, slots[keep] - own[0]] = src[:, keep].to(t.dtype)
    return cache


def cache_insert(cache: dict, k_new, v_new, pos: torch.Tensor) -> dict:
    """Insert one token's (k, v) at absolute positions ``pos [B]`` in
    place (slot ``pos % L``, on a length shard only where it owns the
    slot); an int8 cache quantizes it with the stored hindsight scale."""
    slot = pos % _cache_length(cache)
    b = torch.arange(k_new.shape[0], device=k_new.device)
    kn, vn = k_new[:, 0], v_new[:, 0]
    if "scale" in cache:
        kn = _quant_kv(kn, cache["scale"][0])
        vn = _quant_kv(vn, cache["scale"][1])
    for name, val in (("k", kn), ("v", vn), ("pos", pos)):
        t = cache[name]
        own = _own_range(t)
        if own is None:
            t[b, slot] = val.to(t.dtype)
            continue
        # a row whose slot another shard owns writes its slot 0's own
        # value back: every row writes, so no mask shapes the write
        lo, n = own
        if n == 0:
            continue
        keep = (slot >= lo) & (slot < lo + n)
        idx = torch.where(keep, slot - lo, 0)
        keep = keep.reshape(keep.shape + (1,) * (val.dim() - 1))
        t[b, idx] = torch.where(keep, val.to(t.dtype), t[b, idx])
    return cache


# ---------------------------------------------------------------------------
# The attention layer.
# ---------------------------------------------------------------------------
def attention_layer(params, sites: dict, x: torch.Tensor, *, n_heads: int,
                    n_kv: int, head_dim: int, mode: str = "causal",
                    window: Optional[int] = None,
                    prefix_len: Optional[int] = None,
                    rope_theta: Optional[float] = 10000.0,
                    positions: Optional[torch.Tensor] = None,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_len=None, cache: Optional[dict] = None,
                    policy: QuantPolicy, seed=0, step=0,
                    q_chunk: int = 2048, kv_chunk: int = 1024,
                    dense_attn_max: int = 4096,
                    seq_len: Optional[int] = None):
    """Self- or cross-attention layer (``kv_x [B, Skv, D]``, the encoder's
    output, as the k/v source); returns ``(y, stats, cache)``.
    ``seq_len`` (the sequence-parallel residual, under a model group):
    ``x`` is the rank's ``sharding.split_range`` rows of a sequence of
    ``seq_len``, and so is ``y``."""
    b, s, _ = x.shape
    sp = seq_len is not None and sharding.mp_shard() is not None
    if sp:
        s = seq_len
    scale = head_dim ** -0.5
    # Cross decode: the encoder's projections were cached at prefill
    # (signalled by kv_x=None); no k/v projection runs.
    cross_decode = cache is not None and mode == "cross" and kv_x is None
    decode = cache is not None and s == 1 and mode != "cross"
    local = (mode == "sliding" and window is not None and s > window
             and s % window == 0)
    # The reference's will_use_dense: the sequence-parallel core needs
    # the dense path's whole score tile (the chunked path walks the
    # sequence, and decode has S = 1), whether the int8 core or the fp
    # path then computes it.
    skv = s if kv_x is None else kv_x.shape[1]
    allow_seq = (cache is None and not local and max(s, skv) <= dense_attn_max
                 and s > 1)
    # the model axis: which dim of q ([B, S, KV, G, hd]) and of k / v
    # ([B, S, KV, hd]) this rank holds a slice of
    g = n_heads // n_kv
    mp = sharding.mp_shard()
    layout = None if mp is None else sharding.attn_layout(
        n_kv, g, mp[1], s, allow_seq)
    seq = layout == "seq"
    # the head dim of q a rank holds a share of: (dim, whole size)
    heads = None if layout in (None, "seq") else \
        ((2, n_kv) if layout.startswith("kv") else (3, g))
    q_dim = 1 if seq else None if heads is None else heads[0]
    # a site's model dim; a padded share names its whole size (the noise)
    q_site = heads if layout in ("kv_pad", "g_pad") else q_dim
    kv_dim = 2 if layout == "kv" else None
    par = "col" if heads is not None else None
    kv_par = "col" if layout == "kv" else None
    # a head layout gathers the rank's normed rows, its products' input
    # cotangent reduce-scattered back, and its o product reduce-scatters
    # onto them (Megatron-SP); the "seq" core runs on the rows
    sd = 1 if sp and not seq else None
    if sd is not None:
        x = sharding.mp_gather(x, 1, s)
    q_start = 0
    if seq:
        # the rank's S / M rows of the normed input; the weights are
        # whole (wq / wo / bq gathered from their head shards), their
        # gradients (partial sums over the rows) summed over the group
        # (a cross layer's k / v source is whole on every rank)
        q_start = mp[0] * (s // mp[1])
        if not sp:
            x = sharding.mp_take(x, 1)
        d = x.shape[-1]
        full = {"wq": (d, n_kv, g, head_dim), "wo": (n_kv, g, head_dim, d),
                "bq": (n_kv, g, head_dim)}
        names = ("wq", "wo", "bq") + (("wk", "wv", "bk", "bv")
                                      if kv_x is None else ())

        def whole(n, p):
            dim = sharding.model_dim_of(p)
            if n not in names:
                return p
            p = sharding.unstore(p)     # a stored share: the compute shard
            if dim is None:
                return sharding.mp_grad_sum(p)
            return sharding.mp_gather_sum(p, dim, full[n][dim])
        params = {n: whole(n, params[n])
                  for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")
                  if params.get(n) is not None}
    new_sites = {}
    core_stats = None
    # One shared activation quantization for q/k/v; its range state lives
    # on the "q" site.
    xq, in_stats, xqi = qlinear.act_quant_site(
        x, sites["q"]["act"], policy, step, 1 if seq else None)
    q, sq = qlinear.qdense_pre(xq, params["wq"], sites["q"], policy,
                               einsum_spec="bsd,dkgh->bskgh",
                               bias=params.get("bq"), seed=seed, step=step,
                               qinfo=xqi, parallel=par, y_dim=q_site,
                               seq_dim=sd)
    sq["act"] = in_stats
    new_sites["q"] = sq
    if cross_decode:
        k = v = None
        new_sites["k"], new_sites["v"] = sites["k"], sites["v"]
    else:
        if kv_x is None:
            src_q, src_stats, src_qi = xq, None, xqi
        else:
            # the encoder's output gets its own site, on "k"
            src_q, src_stats, src_qi = qlinear.act_quant_site(
                kv_x, sites["k"]["act"], policy, step)
        kv_y = 1 if seq and kv_x is None else kv_dim
        kv_sd = sd if kv_x is None else None
        k, new_sites["k"] = qlinear.qdense_pre(
            src_q, params["wk"], sites["k"], policy,
            einsum_spec="bsd,dkh->bskh", bias=params.get("bk"),
            seed=seed + 1, step=step, qinfo=src_qi, parallel=kv_par,
            y_dim=kv_y, seq_dim=kv_sd)
        v, new_sites["v"] = qlinear.qdense_pre(
            src_q, params["wv"], sites["v"], policy,
            einsum_spec="bsd,dkh->bskh", bias=params.get("bv"),
            seed=seed + 2, step=step, qinfo=src_qi, parallel=kv_par,
            y_dim=kv_y, seq_dim=kv_sd)
        if src_stats is not None:
            new_sites["k"]["act"] = src_stats

    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    if seq:
        positions = positions[:, q_start:q_start + x.shape[1]]
    # no rotation across the encoder/decoder boundary
    if rope_theta is not None and mode != "cross":
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if seq and kv_x is None:
        # every rank's rows of k and v (fp: the core's k / v sites then
        # quantize the whole tensors, as one process does)
        k, v = sharding.mp_gather(k, 1), sharding.mp_gather(v, 1)

    # The dispatch, decided once.
    use_core = (not (cross_decode or decode) and "core" in sites and s > 1
                and backend.qattention_eligible(policy)
                and (mode != "sliding" or isinstance(window, int))
                and (mode != "prefix" or isinstance(prefix_len, int)))
    dense = (not (cross_decode or decode or use_core or local)
             and max(s, skv) <= dense_attn_max)
    q, k, v = sharding.attn_hints(q, k, v, allow_seq=allow_seq)
    k_all, v_all = k, v     # what the cache takes
    core_kv_dim = kv_dim
    if layout == "kv_pad" and not (cross_decode or decode):
        # q holds the rank's KV heads: k, v sliced to them, their
        # cotangent gathered (every rank's gradient sites see it whole)
        k, v = sharding.mp_take(k, 2), sharding.mp_take(v, 2)
        core_kv_dim = (2, n_kv)
    if layout in ("g", "seq", "g_pad") and not use_core and k is not None:
        # whole k, v against the rank's G heads or rows: their cotangent
        # summed in fp32 before its one cast back (f; the fp paths read
        # fp32 k / v, and the int8 core sums it in fp32 itself)
        k = sharding.mp_grad_sum(k.to(torch.float32))
        v = sharding.mp_grad_sum(v.to(torch.float32))

    if cross_decode:
        # the whole cached encoder: every filled slot is at or before 2**30
        out = _decode_cached(q, cache,
                             torch.full((b,), 2 ** 30, device=x.device),
                             heads, mode="cross_dec", window=None,
                             prefix_len=None, scale=scale)
    elif decode:
        cur = positions[:, 0]
        cache = cache_insert(cache, k, v, cur)
        out = _decode_cached(q, cache, cur, heads, mode=mode, window=window,
                             prefix_len=prefix_len, scale=scale)
    else:
        if use_core:
            out, core_stats = backend.qattention(
                policy, q, k, v, sites["core"], mode=mode, window=window,
                prefix_len=prefix_len, kv_len=kv_len, scale=scale, step=step,
                model_dims=(q_site, core_kv_dim), q_start=q_start,
                sq_total=s)
        elif local:
            out = _local_attn(q, k, v, window=window, scale=scale)
        elif dense:
            out = _dense_attn(q, k, v, mode=mode, window=window,
                              prefix_len=prefix_len, kv_len=kv_len,
                              scale=scale, q_start=q_start)
        else:
            out = _chunked_attn(q, k, v, mode=mode, window=window,
                                prefix_len=prefix_len, kv_len=kv_len,
                                q_start=0, q_chunk=q_chunk,
                                kv_chunk=kv_chunk, scale=scale)
        if cache is not None:
            cache = cache_fill(cache, k_all, v_all)

    if "core" in sites:
        if core_stats is None:
            core_stats = {name: {"act": qlinear.stats_zeros(policy, x.device)}
                          for name in sites["core"]}
        new_sites["core"] = core_stats

    y, new_sites["o"] = qlinear.qeinsum("bskgh,kghd->bsd", out, params["wo"],
                                        sites["o"], policy, seed=seed + 3,
                                        step=step,
                                        parallel="row" if par else None,
                                        x_dim=q_site,
                                        y_dim=1 if seq else None,
                                        seq_dim=sd)
    if seq and not sp:
        # the ranks' rows of the output for the replicated residual stream
        y = sharding.mp_gather(y, 1)
    if params.get("bo") is not None:
        bo = params["bo"]
        if sp:      # added on the rank's rows: its gradient summed
            bo = sharding.mp_grad_sum(bo)
        y = y + bo.to(y.dtype)
    return y, new_sites, cache
