"""RWKV-6 "Finch" block (port of ``repro/models/rwkv6.py``;
arXiv:2404.05892): attention-free, linear-time.

The layer is two sublayers:

  * time-mix: data-dependent-decay linear attention (the WKV recurrence).
    Per head with state ``S in R^{hd x hd}``:

        y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(w_t) S_{t-1} + k_t v_t^T

    where the per-channel decay ``w_t = exp(-exp(w0 + lora_w(x)))`` is a
    function of the input, and the r/k/v/w/g inputs are "ddlerp"
    token-shift mixes of (x_t, x_{t-1}).

  * channel-mix: the RWKV FFN, ``sigmoid(r) * W_v(relu(W_k x)^2)``.

All five time-mix projections (r, k, v, g, o) and the channel mix's three
(k, v, r) are quant sites on the int8 path; the LoRA mixers, the
recurrence and the group norm stay fp32 plain PyTorch, as the reference
keeps them in ``jnp`` (no Pallas kernel exists for them).

:func:`wkv_chunked` evaluates the recurrence chunk by chunk as the
reference does (the same per-element ops: cumulative log decays, the
``[c, c, hd]`` decay tile masked to the strict lower triangle *after*
``exp``, the bonus ``u`` on the diagonal, the state term), but the terms
that do not depend on the carried state are computed for groups of chunks
at once (at most ``_TILE_BYTES`` of decay tiles a group); only the state
recurrence ``S <- exp(cs_last) S + kdec^T v`` loops over the chunks, and
its contribution to ``y`` is one batched product after the loop.  The
reference scans the chunks with ``lax.scan``.  Its ``hint`` /
``hint_heads`` sharding hints are called at their places
(``runtime.sharding``).

Under a model group (``runtime.sharding.model_parallel``) the time mix
is head-parallel, as the reference's hint on the WKV inputs keeps it: a
rank holds its ``H / M`` heads' columns of ``w_r``, ``w_k``, ``w_v``,
``w_g`` (column-parallel) and rows of ``w_o`` (row-parallel: int32
partials summed before the epilogue), and the WKV, its state, the group
norm and the bonus run on those heads, with the rank's slices of the
whole ``u``, ``ln_x_*`` and the decay (``sharding.mp_take``: their
gradients, and the decay LoRA's, gathered whole on every rank).  The
channel mix is a Megatron pair on ``d_ff`` (``w_k`` column-, ``w_v``
row-parallel); ``w_r`` is column-parallel too, its output gathered for
the gate.  The ``[B, S, 5, D]`` bf16 token-shift mix is held whole on
every rank: the reference shards it over the sequence (its ``hint``)
and re-shards it to heads before the products, one all-to-all under
GSPMD; here the column-parallel products read every row of it, so a
sequence shard would be gathered back before the first product.  Whole,
it costs a rank ``10 B S D`` bytes (168 MB at rwkv6-7b's 4 x 1024).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.runtime import sharding

from .layers import activation, init_normal

# The decay tiles of one group of chunks (B * H * n * c * c * hd fp32):
# 64 chunks at rwkv6-7b's 64 heads of 64 and batch 1.
_TILE_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------
def init_rwkv_time_mix(gen: torch.Generator, d: int, n_heads: int, *,
                       shift_rank: int = 32, decay_rank: int = 64,
                       dtype=torch.float32) -> dict:
    """The reference's shapes, dtypes, scales and constants: ``mu_x``,
    ``mu`` all 0.5, ``w0`` -6, ``u`` 0, the group norm's scale 1 and bias
    0, all fp32; the matrices in ``dtype``."""
    dev = gen.device
    f32 = torch.float32
    s = d ** -0.5
    hd = d // n_heads
    return {
        "mu_x": torch.full((d,), 0.5, dtype=f32, device=dev),
        "mu": torch.full((5, d), 0.5, dtype=f32, device=dev),
        "A_mix": init_normal(gen, (d, 5, shift_rank), s, dtype),
        "B_mix": init_normal(gen, (5, shift_rank, d), shift_rank ** -0.5,
                             dtype),
        "w0": torch.full((d,), -6.0, dtype=f32, device=dev),
        "A_w": init_normal(gen, (d, decay_rank), s, dtype),
        "B_w": init_normal(gen, (decay_rank, d), decay_rank ** -0.5, dtype),
        "u": torch.zeros((n_heads, hd), dtype=f32, device=dev),
        "w_r": init_normal(gen, (d, d), s, dtype),
        "w_k": init_normal(gen, (d, d), s, dtype),
        "w_v": init_normal(gen, (d, d), s, dtype),
        "w_g": init_normal(gen, (d, d), s, dtype),
        "w_o": init_normal(gen, (d, d), s, dtype),
        "ln_x_scale": torch.ones((d,), dtype=f32, device=dev),
        "ln_x_bias": torch.zeros((d,), dtype=f32, device=dev),
    }


def init_rwkv_time_sites(device=None) -> dict:
    return {n: qlinear.init_site(device=device)
            for n in ("r", "k", "v", "g", "o")}


def init_rwkv_channel_mix(gen: torch.Generator, d: int, d_ff: int,
                          dtype=torch.float32) -> dict:
    dev = gen.device
    s = d ** -0.5
    return {
        "mu_k": torch.full((d,), 0.5, dtype=torch.float32, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=torch.float32, device=dev),
        "w_k": init_normal(gen, (d, d_ff), s, dtype),
        "w_v": init_normal(gen, (d_ff, d), d_ff ** -0.5, dtype),
        "w_r": init_normal(gen, (d, d), s, dtype),
    }


def init_rwkv_channel_sites(device=None) -> dict:
    return {n: qlinear.init_site(device=device) for n in ("k", "v", "r")}


# ---------------------------------------------------------------------------
# Chunk-parallel WKV core.
# r, k, v: [B, H, T, hd]; logw: [B, H, T, hd] (log decay, < 0);
# u: [H, hd]; state: [B, H, hd, hd] (k-dim x v-dim).
# ---------------------------------------------------------------------------
def _decay_products(r, k, expd):
    """``A[t, i] = sum_d (r[t, d] k[i, d]) expd[t, i, d]`` over chunks
    ``[..., c, hd]``: the reference's three-operand einsum, its products in
    its order, then a sum over ``d``.  (``torch.einsum`` runs that
    contraction as one matrix-vector product per ``(t, i)`` pair, which on
    the card took a third of a 32768-token prefill.)"""
    rk = r[..., :, None, :] * k[..., None, :, :]
    return (rk * expd).sum(-1)


def _chunk_terms(r, k, v, lw, u):
    """The reference's chunk body without the carried state, for ``n``
    chunks at once: inputs ``[n, B, H, c, hd]``.  Returns ``(y_intra, rdec
    [n, B, H, c, hd], decay [n, B, H, hd, 1], kv [n, B, H, hd, hd])``: the
    chunk's own output, ``r exp(cs_prev)`` (what multiplies the incoming
    state), ``exp(cs_last)`` and ``sum_i k_i exp(cs_last - cs_i) v_i^T``."""
    c = r.shape[3]
    cs = torch.cumsum(lw, dim=3)                          # inclusive, fp32
    cs_prev = cs - lw                                     # exclusive
    cs_last = cs[:, :, :, -1:, :]
    # intra-chunk: A[t, i] = sum_d r[t] k[i] exp(cs_prev[t] - cs[i]), i < t.
    # Above the diagonal the exponents are positive and may overflow to
    # inf; the mask zeroes A there after the contraction, as the
    # reference does (its backward then multiplies a zero by inf).
    expd = torch.exp(cs_prev[:, :, :, :, None, :] - cs[:, :, :, None, :, :])
    a = _decay_products(r, k, expd)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    a = torch.where(tri, a, torch.zeros((), dtype=a.dtype, device=a.device))
    # diagonal bonus: u replaces the (empty) decay product at i == t.
    adiag = torch.einsum("nbhtd,hd->nbht", r * k, u)
    y = torch.einsum("nbhti,nbhiv->nbhtv", a, v) + adiag[..., None] * v
    kdec = k * torch.exp(cs_last - cs)
    kv = torch.einsum("nbhtd,nbhtv->nbhdv", kdec, v)
    return (y, r * torch.exp(cs_prev),
            torch.exp(cs_last.transpose(3, 4)), kv)


def _wkv_chunks(r, k, v, lw, u, state):
    """``n`` chunks ``[B, H, n, c, hd]`` from ``state``: returns ``(y [B,
    H, n * c, hd], state)``.  The chunks are laid out chunk-major (one
    copy of each input), so each chunk's terms are contiguous."""
    b, h, n, c, hd = r.shape
    r, k, v, lw = (z.permute(2, 0, 1, 3, 4).contiguous()
                   for z in (r, k, v, lw))
    group = max(1, _TILE_BYTES // (b * h * c * c * hd * 4))
    terms = [_chunk_terms(r[i:i + group], k[i:i + group], v[i:i + group],
                          lw[i:i + group], u)
             for i in range(0, n, group)]
    y, rdec, decay, kv = (torch.cat(t) if len(t) > 1 else t[0]
                          for t in zip(*terms))
    prev = []
    for i in range(n):
        prev.append(state)
        state = decay[i] * state + kv[i]
    # inter-chunk: the state each chunk starts from.
    y = y + torch.einsum("nbhtd,nbhdv->nbhtv", rdec, torch.stack(prev))
    return y.permute(1, 2, 0, 3, 4).reshape(b, h, n * c, hd), state


def wkv_chunked(r, k, v, logw, u, state, chunk: int = 32):
    """Chunk-parallel WKV over arbitrary T: full chunks of ``min(chunk,
    T)``, then one ragged tail chunk.  Returns ``(y [B, H, T, hd],
    state)``."""
    b, h, t, hd = r.shape
    c = min(chunk, t)
    nc = t // c
    rem = t - nc * c
    outs = []
    if nc:
        y, state = _wkv_chunks(
            *(z[:, :, :nc * c].reshape(b, h, nc, c, hd)
              for z in (r, k, v, logw)), u, state)
        outs.append(y)
    if rem:
        y, state = _wkv_chunks(*(z[:, :, nc * c:].unsqueeze(2)
                                 for z in (r, k, v, logw)), u, state)
        outs.append(y)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)), state


def wkv_step(r, k, v, logw, u, state):
    """Single-token recurrence (decode).  r/k/v/logw: ``[B, H, hd]``."""
    kv = torch.einsum("bhd,bhv->bhdv", k, v)
    y = torch.einsum("bhd,bhdv->bhv", r, state + u[None, :, :, None] * kv)
    state = torch.exp(logw)[..., None] * state + kv
    return y, state


# ---------------------------------------------------------------------------
# Layer application.
# ---------------------------------------------------------------------------
def _ddlerp(x, xprev, p):
    """Data-dependent token-shift mix for the five branches (r, k, v, w,
    g): ``[B, S, 5, D]``, rounded to bf16 whatever the compute dtype, as
    the reference stores it."""
    f32 = torch.float32
    xf, pf = x.to(f32), xprev.to(f32)
    delta = pf - xf
    xx = xf + delta * p["mu_x"]
    lora = torch.einsum("bsd,dzr->bszr", torch.tanh(xx), p["A_mix"].to(f32))
    lora = torch.einsum("bszr,zrd->bszd", lora, p["B_mix"].to(f32))
    mix = p["mu"] + lora                                  # [B, S, 5, D]
    out = xf[:, :, None, :] + delta[:, :, None, :] * mix
    out = out.to(torch.bfloat16)
    if x.shape[1] > 1 and x.shape[1] % 16 == 0:
        out = sharding.hint(out, "batch", "model", None, None)
    return out


def _group_norm(y, scale, bias, n_heads, eps=1e-5):
    b, s, d = y.shape
    hd = d // n_heads
    yg = y.reshape(b, s, n_heads, hd).to(torch.float32)
    mu = torch.sum(yg, dim=-1, keepdim=True) / hd
    dev = yg - mu
    var = torch.sum(dev * dev, dim=-1, keepdim=True) / hd
    yn = (dev * torch.rsqrt(var + eps)).reshape(b, s, d)
    return yn * scale + bias


def _shifted(x, x_prev):
    """``[x_prev, x_0, ..., x_{S-2}]``: each token's predecessor."""
    if x_prev is None:
        x_prev = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                             device=x.device)
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def rwkv_time_mix(params, sites: dict, x: torch.Tensor, *, n_heads: int,
                  policy: QuantPolicy, seed, step, chunk: int = 32,
                  state=None, x_prev=None, seq_dim: Optional[int] = None):
    """x ``[B, S, D]``; ``state`` ``[B, H, hd, hd]`` fp32 and ``x_prev``
    ``[B, D]`` carry decode context.  Returns ``(y, stats, (state,
    x_last))``.  ``seq_dim``: ``x`` is the ranks' rows gathered along it
    (the token shift and the WKV need the whole sequence) and ``y`` this
    rank's rows (the sequence-parallel residual)."""
    b, s, d = x.shape
    hd = d // n_heads
    f32 = torch.float32
    # the model axis: the rank's heads (the last dim's columns)
    mp = sharding.mp_shard()
    col, row, cdim = ("col", "row", -1) if mp else (None, None, None)
    heads_here = n_heads // (mp[1] if mp else 1)
    # bf16 [B, S, 5, D]: the r, k, v, w, g mixes
    mixed = _ddlerp(x, _shifted(x, x_prev), params)

    new_sites = {}
    out = {}
    for i, (n, j) in enumerate((("r", 0), ("k", 1), ("v", 2), ("g", 4))):
        out[n], new_sites[n] = qlinear.qdense(
            mixed[:, :, j].to(x.dtype), params[f"w_{n}"], sites[n], policy,
            seed=seed + i, step=step, parallel=col, y_dim=cdim)

    # data-dependent decay (fp32, tiny LoRA)
    dw = torch.einsum("bsd,dr->bsr", torch.tanh(mixed[:, :, 3].to(f32)),
                      params["A_w"].to(f32))
    dw = torch.einsum("bsr,rd->bsd", dw, params["B_w"].to(f32))
    logw = -torch.exp(params["w0"] + dw)                  # [B, S, D], < 0
    logw = sharding.mp_take(logw, -1)

    def heads(z):
        # the WKV recurrence is head-parallel: H over the model axis
        return sharding.hint_heads(
            z.reshape(b, s, heads_here, hd).transpose(1, 2).to(f32),
            kv_axis=1, g_axis=1)

    if state is None:
        state = torch.zeros((b, heads_here, hd, hd), dtype=f32,
                            device=x.device)
    r, k, v, lw = (heads(z) for z in (out["r"], out["k"], out["v"], logw))
    u = sharding.mp_take(params["u"], 0)
    if s == 1:
        y, state = wkv_step(r[:, :, 0], k[:, :, 0], v[:, :, 0], lw[:, :, 0],
                            u, state)
        y = y[:, :, None, :]
    else:
        y, state = wkv_chunked(r, k, v, lw, u, state, chunk=chunk)

    y = y.transpose(1, 2).reshape(b, s, heads_here * hd)
    y = _group_norm(y, sharding.mp_take(params["ln_x_scale"], 0),
                    sharding.mp_take(params["ln_x_bias"], 0), heads_here)
    y = (y * activation(out["g"].to(f32), "silu")).to(x.dtype)
    o, new_sites["o"] = qlinear.qdense(y, params["w_o"], sites["o"], policy,
                                       seed=seed + 4, step=step,
                                       parallel=row, x_dim=cdim,
                                       seq_dim=seq_dim)
    return o, new_sites, (state, x[:, -1])


def rwkv_channel_mix(params, sites: dict, x: torch.Tensor, *,
                     policy: QuantPolicy, seed, step, x_prev=None,
                     seq_dim: Optional[int] = None):
    """x ``[B, S, D]``; ``x_prev`` ``[B, D]``.  Returns ``(y, stats,
    x_last)``.  ``seq_dim``: as :func:`rwkv_time_mix`'s (``w_v``'s
    product reduce-scatters, the gate takes the rank's rows)."""
    f32 = torch.float32
    xf, pf = x.to(f32), _shifted(x, x_prev).to(f32)
    xk = (xf + (pf - xf) * params["mu_k"]).to(x.dtype)
    xr = (xf + (pf - xf) * params["mu_r"]).to(x.dtype)

    new_sites = {}
    # the model axis: a Megatron pair on d_ff (w_k, w_v); w_r's columns,
    # gathered for the gate
    tp = sharding.mp_shard() is not None
    col, row, cdim = ("col", "row", -1) if tp else (None, None, None)
    kk, new_sites["k"] = qlinear.qdense(xk, params["w_k"], sites["k"],
                                        policy, seed=seed, step=step,
                                        parallel=col, y_dim=cdim)
    h = activation(kk, "sq_relu")
    vv, new_sites["v"] = qlinear.qdense(h, params["w_v"], sites["v"], policy,
                                        seed=seed + 1, step=step,
                                        parallel=row, x_dim=cdim,
                                        seq_dim=seq_dim if tp else None)
    rr, new_sites["r"] = qlinear.qdense(xr, params["w_r"], sites["r"],
                                        policy, seed=seed + 2, step=step,
                                        parallel=col, y_dim=cdim)
    rr = sharding.mp_gather(rr, -1)
    if tp and seq_dim is not None:
        rr = sharding.mp_take(rr, seq_dim)
    y = (torch.sigmoid(rr.to(f32)) * vv.to(f32)).to(x.dtype)
    return y, new_sites, x[:, -1]
