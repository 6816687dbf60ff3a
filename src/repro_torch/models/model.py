"""Model entry points (port of ``repro/models/model.py``): init, the
trunk, the training loss ``loss_fn`` with the chunked quantized LM head,
and ``prefill`` / ``decode_step`` of every LM family.  The MoE, hybrid
and RWKV-6 families have no branch of their own here: their ``"moe"``,
``"rec"`` / ``"local"`` and ``"rwkv"`` blocks live in the stack (an
attention-free stack reads no positions), whose summed ``aux_loss`` /
``z_loss`` the loss adds.  The enc-dec family runs an encoder stack on
its ``frames`` (a stub frontend: precomputed frame embeddings through the
quantized linear ``enc_in``) and hands its output to the decoder's cross
attention; the VLM family puts its ``patches`` (through ``patch_proj``)
before the token embeddings as a prefix the decoder attends
bidirectionally.

Batches: ``{"tokens", "labels", "mask"}`` (``[B, S]``), plus ``"frames"
[B, Senc, frontend_dim]`` (enc-dec) or ``"patches" [B, P,
frontend_dim]`` (VLM; the loss covers the text suffix only).  Decode
takes no frontend: enc-dec decode reads the cross cache.

The LM head evaluates the loss in sequence chunks so ``[B, S, V]`` logits
never exist; both head quantizers act on the head *input* (``Q_Y`` on the
way in, ``Q_G`` on the same tensor), so the cotangent that re-enters the
trunk is quantized once, whatever the chunking.  As in the reference,
prefill/decode project only the last position onto the vocabulary, with
the quantized head weight, in plain fp32 (outside any quant site).

Under a model group (``runtime.sharding.model_parallel``) the embedding
and the head are vocab-parallel: a rank holds ``V / M`` rows of
``embed`` (columns of ``head``), ``sharding.split_range``'s share where
``M`` does not divide ``V`` (256206 over 8: 32026 x 7 + 32024).  The
lookup is masked to the rank's rows and summed over the group (one
nonzero term a token: exact); the head's chunks compute the rank's
vocabulary columns, and the cross entropy takes the row max (an
all_reduce MAX) and the sum of exps and the gold logit (SUM) over the
group; prefill and decode gather the last position's logits, whose
greedy argmax is then the one process's.

Under the sequence-parallel residual (``sharding.seq_rows``, the step
factories' ``seq_shard``) the trunk's stacks run on the rank's
``sharding.split_range`` rows of the sequence: the lookup's sum is a
reduce-scatter onto them (still one nonzero term a row), a frontend's
whole output (``enc_in``, the VLM's prefix with its tokens) takes them,
and the final norms run on them before the rows are gathered for the
head, the loss and the cross attention's ``enc_out``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import backend, qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import resolve_device
from repro_torch.runtime import sharding
from repro_torch.telemetry import metrics

from . import layers, transformer
from .param_tree import ParamTree


# ===========================================================================
# Init.
# ===========================================================================
def init_params(cfg, seed: int = 0, device=None) -> ParamTree:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the CUDA card unless ``"cpu"`` is asked for)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))
    dt = getattr(torch, cfg.param_dtype)
    p: dict = {"embed": layers.init_embedding(gen, cfg.vocab, cfg.d_model,
                                              dt)}
    dev = gen.device
    if cfg.family == "encdec":
        p["enc_in"] = layers.init_normal(gen, (cfg.frontend_dim, cfg.d_model),
                                         cfg.frontend_dim ** -0.5, dt)
        p["encoder"] = transformer.init_stack(gen, cfg, cfg.enc_pattern,
                                              cfg.enc_layers)
        p["enc_norm"] = layers.init_norm(cfg.d_model, cfg.norm_kind,
                                         cfg.use_bias, dev)
    if cfg.family == "vlm":
        p["patch_proj"] = layers.init_normal(
            gen, (cfg.frontend_dim, cfg.d_model), cfg.frontend_dim ** -0.5,
            dt)
    p["decoder"] = transformer.init_stack(gen, cfg, cfg.pattern,
                                          cfg.n_layers)
    p["final_norm"] = layers.init_norm(cfg.d_model, cfg.norm_kind,
                                       cfg.use_bias, dev)
    if not cfg.tie_embeddings:
        p["head"] = layers.init_normal(gen, (cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5, dt)
    return ParamTree(p)


def init_quant_state(cfg, policy: Optional[QuantPolicy] = None,
                     device=None) -> dict:
    """Width-3 site leaves, widened once here when ``policy`` has
    telemetry enabled (no site builder knows the extended layout)."""
    device = resolve_device(device)
    s = {"decoder": transformer.init_stack_sites(cfg, cfg.pattern,
                                                 cfg.n_layers, device),
         "head": qlinear.init_site(device=device)}
    if cfg.family == "encdec":
        s["enc_in"] = qlinear.init_site(device=device)
        s["encoder"] = transformer.init_stack_sites(cfg, cfg.enc_pattern,
                                                    cfg.enc_layers, device)
    if cfg.family == "vlm":
        s["patch_proj"] = qlinear.init_site(device=device)
    if policy is not None:
        s = metrics.widen_state(s, policy.stat_width)
    return s


def init_cache(cfg, batch: int, cache_len: int, device=None) -> dict:
    """The decode caches; under a model group a rank's slices of them
    (``sharding.cache_pspecs``' rules, recorded on the tensors)."""
    return {"decoder": transformer.init_stack_cache(
        cfg, cfg.pattern, cfg.n_layers, batch, cache_len,
        resolve_device(device))}


# ===========================================================================
# Trunk.
# ===========================================================================
def _vocab_slice(ids: torch.Tensor, vocab: int):
    """``(local index, inside)`` of vocabulary ids against this model
    rank's share of the ``vocab`` rows (``sharding.split_range``;
    ``inside``: the rank holds the id; the index of the others is
    clamped into range)."""
    lo, n = sharding.split_range(vocab, *reversed(sharding.mp_shard()))
    local = ids - lo
    inside = (local >= 0) & (local < n)
    return local.clamp(0, max(n - 1, 0)), inside


def _take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; zeros where the rank holds no rows of the table."""
    if table.shape[0]:
        return table[ids]
    return table.new_zeros(tuple(ids.shape) + tuple(table.shape[1:]))


def _embed_tokens(params, tokens, cfg, policy,
                  rows_only: bool = False) -> torch.Tensor:
    """Quantizes the whole table (current min-max), then gathers rows.
    Without a recorded gradient the rows are dequantized after the gather —
    the same elementwise ops as the reference's dequantize-then-gather,
    without a full fp copy; with one, the on-grid table carries the STE.
    Vocab-parallel under a model group (module docstring);
    ``rows_only``: the rank's rows of the sequence (the sum a
    reduce-scatter)."""
    tp = sharding.mp_shard() is not None
    table, qt = qlinear.quantize_weight_q(params["embed"], policy,
                                          sharded=tp)
    ids, inside = (tokens, None) if not tp else _vocab_slice(tokens,
                                                             cfg.vocab)
    if table is not None:
        rows = _take_rows(table, ids)
    else:
        rows = backend.dequantize_qtensor(
            backend.QTensor(_take_rows(qt.q, ids), qt.scale, qt.zero_point))
    if tp:
        part = torch.where(inside[..., None], rows.to(torch.float32), 0.0)
        part = sharding.mp_scatter(part, 1) if rows_only else \
            sharding.mp_sum(part)
        rows = part.to(rows.dtype)
    x = rows.to(getattr(torch, cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _trunk(params, sites, batch, cfg, policy, seed, step, caches=None):
    """Returns ``(hidden [B, S, D], stats, caches, metrics{aux_loss,
    z_loss})``; for the VLM family ``S`` counts the image prefix."""
    new_sites: dict = {}
    enc_out = enc_len = prefix_len = None
    metrics = None
    dt = getattr(torch, cfg.compute_dtype)
    sp = sharding.seq_rows()

    def rows(t):        # the rank's rows of a tensor whole on every rank
        return sharding.mp_take(t, 1) if sp else t

    def whole(t, n):    # the ranks' rows of n gathered
        return sharding.mp_gather(t, 1, n) if sp else t

    if cfg.family == "encdec" and "frames" in batch:
        frames = batch["frames"].to(dt)
        ex, new_sites["enc_in"] = qlinear.qdense(
            frames, params["enc_in"], sites["enc_in"], policy,
            seed=seed + 1_000_000, step=step)
        epos = torch.arange(ex.shape[1], device=ex.device).expand(
            ex.shape[:2])
        enc_out, new_sites["encoder"], _, metrics = transformer.apply_stack(
            params["encoder"], sites["encoder"], rows(ex), cfg=cfg,
            pattern=cfg.enc_pattern, policy=policy, seed=seed + 2_000_000,
            step=step, positions=epos)
        enc_out = whole(layers.apply_norm(enc_out, params["enc_norm"],
                                          cfg.norm_kind), ex.shape[1])
        enc_len = batch.get("frame_len")

    b, s = batch["tokens"].shape
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(dt)
        px, new_sites["patch_proj"] = qlinear.qdense(
            patches, params["patch_proj"], sites["patch_proj"], policy,
            seed=seed + 3_000_000, step=step)
        tx = _embed_tokens(params, batch["tokens"], cfg, policy)
        x = rows(torch.cat([px, tx], dim=1))
        prefix_len = patches.shape[1]
        s += prefix_len
    else:
        x = _embed_tokens(params, batch["tokens"], cfg, policy,
                          rows_only=sp)

    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    x, new_sites["decoder"], new_caches, dmet = transformer.apply_stack(
        params["decoder"], sites["decoder"], x, cfg=cfg, pattern=cfg.pattern,
        policy=policy, seed=seed, step=step, positions=positions,
        caches=caches, enc_out=enc_out, enc_len=enc_len,
        prefix_len=prefix_len)
    if metrics is not None:
        dmet = {k: metrics[k] + dmet[k] for k in dmet}
    x = whole(layers.apply_norm(x, params["final_norm"], cfg.norm_kind), s)
    return x, new_sites, new_caches, dmet


def _head_weight_q(params, cfg, policy, fn=qlinear.quantize_weight_q):
    """``fn`` (``qlinear.quantize_weight_q`` / ``quantize_weight``) of the
    head weight: ``head``, or the tied ``embed`` transposed after its
    gather (a stored ``embed`` is gathered on its own dims)."""
    tied = cfg.tie_embeddings
    return fn(params["embed" if tied else "head"], policy,
              sharded=sharding.mp_shard() is not None, transpose=tied)


def _head_weight(params, cfg, policy) -> torch.Tensor:
    return _head_weight_q(params, cfg, policy, qlinear.quantize_weight)


def _logits(params, x, cfg, policy) -> torch.Tensor:
    """The last position's logits ``[B, V]`` (under a model group, the
    ranks' vocabulary columns gathered)."""
    y = torch.matmul(x[:, -1].to(torch.float32),
                     _head_weight(params, cfg, policy).to(torch.float32))
    return sharding.mp_gather(y, 1, total=cfg.vocab)


# ===========================================================================
# Training forward + chunked loss.
# ===========================================================================
def _chunk_loss(logits, labels, mask, vocab: int):
    """``(sum of nll, sum of logz**2)`` over the chunk's masked tokens;
    under a model group ``logits`` are the rank's vocabulary columns (its
    ``split_range`` share of ``vocab``) and the reductions over V run
    across the group."""
    if sharding.mp_shard() is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        part = logits.detach().amax(dim=-1) if logits.shape[-1] else \
            logits.new_full(logits.shape[:-1], float("-inf")).detach()
        m = sharding.mp_max(part)
        se = sharding.mp_sum(torch.sum(torch.exp(logits - m[..., None]),
                                       dim=-1))
        logz = torch.log(se) + m
        idx, inside = _vocab_slice(labels, vocab)
        picked = torch.gather(logits, -1, idx[..., None])[..., 0] \
            if logits.shape[-1] else logits.new_zeros(labels.shape)
        gold = sharding.mp_sum(torch.where(inside, picked, 0.0))
    return torch.sum((logz - gold) * mask), torch.sum(logz.square() * mask)


def _chunk_nll(policy, vocab, xqi, wq, wqt, xcb, qcb, lcb, mcb):
    """One head chunk: logits ``[B, c, V]`` through the backend contraction
    (the int8 kernel path when both images exist), then (nll, z-penalty);
    column-parallel under a model group (the rank's V columns)."""
    par = None if sharding.mp_shard() is None else "col"
    if qcb is not None:
        logits = backend.qmatmul(
            policy, "bcd,dv->bcv", xcb,
            backend.QTensor(qcb, xqi.scale, xqi.zero_point), wq, wqt,
            out_dtype=torch.float32, parallel=par)
    else:
        xf = xcb.to(torch.float32)
        if par is not None:
            xf = sharding.mp_grad_sum(xf)
        logits = torch.einsum("bcd,dv->bcv", xf, wq.to(torch.float32))
    return _chunk_loss(logits, lcb, mcb, vocab)


def loss_fn(params, quant_state, batch, cfg, policy: QuantPolicy, seed: int,
            step):
    """Returns ``(loss, (new_quant_state_fwd, metrics))``.

    ``new_quant_state_fwd`` carries the forward (activation-site)
    statistics; gradient-site statistics arrive as the gradients of the
    quant state's grad leaves (see ``runtime.steps.make_train_step``).
    As in the reference, the head's grad slot carries the head's grad
    *leaf* itself rather than a "not visited" vector."""
    seed = int(seed)
    x, new_sites, _, metrics = _trunk(params, quant_state, batch, cfg,
                                      policy, seed, step)
    labels = batch["labels"]
    mask = batch["mask"].to(torch.float32)
    if cfg.family == "vlm":
        # the loss covers the text suffix; the hidden states hold the prefix
        x = x[:, batch["patches"].shape[1]:]

    site = quant_state["head"]
    xq, new_head_act, xqi = qlinear.act_quant_site(x, site["act"], policy,
                                                   step)
    xq = qlinear.grad_quant_barrier(xq, site["grad"], policy,
                                    seed + 7_000_000, step)
    wq, wqt = _head_weight_q(params, cfg, policy)
    if wq is not None:
        wq = wq.to(xq.dtype)

    b, s, d = xq.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    use_int = (xqi is not None and wqt is not None
               and backend.int8_matmul_eligible(policy))
    chunk = functools.partial(_chunk_nll, policy, cfg.vocab, xqi, wq, wqt)
    nlls, zpens = [], []
    for lo in range(0, s, c):
        sl = slice(lo, lo + c)
        args = (xq[:, sl], xqi.q[:, sl] if use_int else None, labels[:, sl],
                mask[:, sl])
        if cfg.remat and torch.is_grad_enabled():
            nll, zpen = checkpoint(chunk, *args, use_reentrant=False)
        else:
            nll, zpen = chunk(*args)
        nlls.append(nll)
        zpens.append(zpen)
    # the global batch's token count under data parallelism: every rank's
    # loss is its share of the global mean
    denom = torch.clamp(sharding.dp_sum(torch.sum(mask)), min=1.0)
    loss = torch.sum(torch.stack(nlls)) / denom
    metrics["z_loss_head"] = cfg.logit_z_coef * torch.sum(
        torch.stack(zpens)) / denom
    total = loss + metrics["aux_loss"] + metrics["z_loss"] + \
        metrics["z_loss_head"]
    metrics["nll"] = loss

    new_quant_state = dict(new_sites)
    new_quant_state["head"] = {"act": new_head_act, "grad": site["grad"]}
    return total, (new_quant_state, metrics)


# ===========================================================================
# Serving.
# ===========================================================================
@torch.no_grad()
def prefill(params, quant_state, batch, cfg, policy: QuantPolicy,
            cache_len: Optional[int] = None, return_stats: bool = False):
    """Run the prompt and build the decode cache.  Returns ``(last_logits
    [B, V], caches)`` (plus the forward stats tree with
    ``return_stats``).  ``cache_len`` defaults to the prompt's length (the
    VLM's patches counted); an enc-dec cross cache has
    ``cfg.enc_len(cache_len)`` slots and keeps the last of a longer
    encoder sequence."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cfg.family == "vlm":
        s = s + batch["patches"].shape[1]
    caches = init_cache(cfg, b, cache_len or s, tokens.device)
    x, fwd_stats, new_caches, _ = _trunk(params, quant_state, batch, cfg,
                                         policy, 0, 0,
                                         caches=caches["decoder"])
    logits = _logits(params, x, cfg, policy)
    if return_stats:
        return logits, {"decoder": new_caches}, fwd_stats
    return logits, {"decoder": new_caches}


@torch.no_grad()
def decode_step(params, quant_state, token, pos, caches, cfg,
                policy: QuantPolicy):
    """One decode step: ``token [B, 1]`` at absolute positions ``pos
    [B]``.  Returns ``(logits [B, V], caches)``; the caches are updated
    in place."""
    batch = {"tokens": token, "positions": pos[:, None].expand(token.shape)}
    x, _, new_caches, _ = _trunk(params, quant_state, batch, cfg, policy,
                                 0, 0, caches=caches["decoder"])
    return _logits(params, x, cfg, policy), {"decoder": new_caches}
