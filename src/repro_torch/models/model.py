"""Model entry points (port of ``repro/models/model.py``): init, the
trunk, the training loss ``loss_fn`` with the chunked quantized LM head,
and ``prefill`` / ``decode_step`` of the dense, MoE, hybrid and RWKV-6 LM
families (the enc-dec and VLM branches come with their families).
None of the MoE, hybrid and RWKV-6 families has a branch of its own here:
their ``"moe"``, ``"rec"`` / ``"local"`` and ``"rwkv"`` blocks live in
the stack (an attention-free stack reads no positions),
whose summed ``aux_loss`` / ``z_loss`` the loss adds.

The LM head evaluates the loss in sequence chunks so ``[B, S, V]`` logits
never exist; both head quantizers act on the head *input* (``Q_Y`` on the
way in, ``Q_G`` on the same tensor), so the cotangent that re-enters the
trunk is quantized once, whatever the chunking.  As in the reference,
prefill/decode project only the last position onto the vocabulary, with
the quantized head weight, in plain fp32 (outside any quant site).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import backend, qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import resolve_device
from repro_torch.telemetry import metrics

from . import layers, transformer
from .param_tree import ParamTree


_FAMILIES = ("dense", "moe", "hybrid", "rwkv")


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet")


# ===========================================================================
# Init.
# ===========================================================================
def init_params(cfg, seed: int = 0, device=None) -> ParamTree:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the CUDA card unless ``"cpu"`` is asked for)."""
    _check_family(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))
    dt = getattr(torch, cfg.param_dtype)
    p: dict = {"embed": layers.init_embedding(gen, cfg.vocab, cfg.d_model,
                                              dt)}
    p["decoder"] = transformer.init_stack(gen, cfg, cfg.n_layers)
    p["final_norm"] = layers.init_norm(cfg.d_model, cfg.norm_kind,
                                       cfg.use_bias, gen.device)
    if not cfg.tie_embeddings:
        p["head"] = layers.init_normal(gen, (cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5, dt)
    return ParamTree(p)


def init_quant_state(cfg, policy: Optional[QuantPolicy] = None,
                     device=None) -> dict:
    """Width-3 site leaves, widened once here when ``policy`` has
    telemetry enabled (no site builder knows the extended layout)."""
    _check_family(cfg)
    device = resolve_device(device)
    s = {"decoder": transformer.init_stack_sites(cfg, cfg.n_layers, device),
         "head": qlinear.init_site(device=device)}
    if policy is not None:
        s = metrics.widen_state(s, policy.stat_width)
    return s


def init_cache(cfg, batch: int, cache_len: int, device=None) -> dict:
    return {"decoder": transformer.init_stack_cache(
        cfg, cfg.n_layers, batch, cache_len, resolve_device(device))}


# ===========================================================================
# Trunk.
# ===========================================================================
def _embed_tokens(params, tokens, cfg, policy) -> torch.Tensor:
    """Quantizes the whole table (current min-max), then gathers rows.
    Without a recorded gradient the rows are dequantized after the gather —
    the same elementwise ops as the reference's dequantize-then-gather,
    without a full fp copy; with one, the on-grid table carries the STE."""
    table, qt = qlinear.quantize_weight_q(params["embed"], policy)
    if table is not None:
        rows = table[tokens]
    else:
        rows = backend.dequantize_qtensor(
            backend.QTensor(qt.q[tokens], qt.scale, qt.zero_point))
    x = rows.to(getattr(torch, cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _trunk(params, sites, batch, cfg, policy, seed, step, caches=None):
    """Returns ``(hidden [B, S, D], stats, caches, metrics{aux_loss,
    z_loss})``."""
    _check_family(cfg)
    x = _embed_tokens(params, batch["tokens"], cfg, policy)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
    x, dec_sites, new_caches, metrics = transformer.apply_stack(
        params["decoder"], sites["decoder"], x, cfg=cfg, policy=policy,
        seed=seed, step=step, positions=positions, caches=caches)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm_kind)
    return x, {"decoder": dec_sites}, new_caches, metrics


def _head_weight_raw(params, cfg) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _head_weight(params, cfg, policy) -> torch.Tensor:
    return qlinear.quantize_weight(_head_weight_raw(params, cfg), policy)


def _logits(params, x, cfg, policy) -> torch.Tensor:
    return torch.matmul(x[:, -1].to(torch.float32),
                        _head_weight(params, cfg, policy).to(torch.float32))


# ===========================================================================
# Training forward + chunked loss.
# ===========================================================================
def _chunk_loss(logits, labels, mask):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(logz.square() * mask)


def _chunk_nll(policy, xqi, wq, wqt, xcb, qcb, lcb, mcb):
    """One head chunk: logits ``[B, c, V]`` through the backend contraction
    (the int8 kernel path when both images exist), then (nll, z-penalty)."""
    if qcb is not None:
        logits = backend.qmatmul(
            policy, "bcd,dv->bcv", xcb,
            backend.QTensor(qcb, xqi.scale, xqi.zero_point), wq, wqt,
            out_dtype=torch.float32)
    else:
        logits = torch.einsum("bcd,dv->bcv", xcb.to(torch.float32),
                              wq.to(torch.float32))
    return _chunk_loss(logits, lcb, mcb)


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

    site = quant_state["head"]
    xq, new_head_act, xqi = qlinear.act_quant_site(x, site["act"], policy,
                                                   step)
    xq = qlinear.grad_quant_barrier(xq, site["grad"], policy,
                                    seed + 7_000_000, step)
    wq, wqt = qlinear.quantize_weight_q(_head_weight_raw(params, cfg), policy)
    if wq is not None:
        wq = wq.to(xq.dtype)

    b, s, d = xq.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    use_int = (xqi is not None and wqt is not None
               and backend.int8_matmul_eligible(policy))
    chunk = functools.partial(_chunk_nll, policy, xqi, wq, wqt)
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
    denom = torch.clamp(torch.sum(mask), min=1.0)
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
    ``return_stats``)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
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
