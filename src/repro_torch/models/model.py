"""Model entry points for serving (port of ``repro/models/model.py``):
init, the trunk, ``prefill`` and ``decode_step`` of the dense LM family.

``loss_fn`` (the chunked quantized LM head) comes with the training slice;
the enc-dec and VLM branches with their families.  As in the reference,
prefill/decode project only the last position onto the vocabulary, with
the quantized head weight, in plain fp32 (outside any quant site).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import backend, qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import resolve_device

from . import layers, transformer
from .param_tree import ParamTree


def _check_family(cfg) -> None:
    if cfg.family != "dense":
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
    _check_family(cfg)
    if policy is not None and policy.stat_width != 3:
        raise NotImplementedError(
            "telemetry-width quant state comes with the telemetry slice")
    device = resolve_device(device)
    return {"decoder": transformer.init_stack_sites(cfg, cfg.n_layers,
                                                    device),
            "head": qlinear.init_site(device=device)}


def init_cache(cfg, batch: int, cache_len: int, device=None) -> dict:
    return {"decoder": transformer.init_stack_cache(
        cfg, cfg.n_layers, batch, cache_len, resolve_device(device))}


# ===========================================================================
# Trunk.
# ===========================================================================
def _embed_tokens(params, tokens, cfg, policy) -> torch.Tensor:
    """Quantizes the whole table (current min-max), then gathers rows.
    The rows are dequantized after the gather — the same elementwise ops
    as the reference's dequantize-then-gather, without a full fp copy."""
    table, qt = qlinear.quantize_weight_q(params["embed"], policy)
    if qt is None:
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
    """Returns ``(hidden [B, S, D], stats, caches)``."""
    _check_family(cfg)
    x = _embed_tokens(params, batch["tokens"], cfg, policy)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
    x, dec_sites, new_caches = transformer.apply_stack(
        params["decoder"], sites["decoder"], x, cfg=cfg, policy=policy,
        seed=seed, step=step, positions=positions, caches=caches)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm_kind)
    return x, {"decoder": dec_sites}, new_caches


def _head_weight(params, cfg, policy) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return qlinear.quantize_weight(w, policy)


def _logits(params, x, cfg, policy) -> torch.Tensor:
    return torch.matmul(x[:, -1].to(torch.float32),
                        _head_weight(params, cfg, policy).to(torch.float32))


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
    x, fwd_stats, new_caches = _trunk(params, quant_state, batch, cfg,
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
    x, _, new_caches = _trunk(params, quant_state, batch, cfg, policy, 0, 0,
                              caches=caches["decoder"])
    return _logits(params, x, cfg, policy), {"decoder": new_caches}
