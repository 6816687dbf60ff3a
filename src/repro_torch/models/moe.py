"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``: the
Qwen2-MoE / Moonlight family).

GShard-style capacity-bounded einsum dispatch, as the reference:

  * router: fp32 dense, not quantized (the top-k boundary is numerically
    sensitive and the matmul is tiny),
  * top-k gating, probabilities renormalized over the selected experts,
  * tokens grouped into fixed-size groups, capacity
    ``C = ceil(group_size * top_k / E * capacity_factor)`` clamped to
    ``[4, group_size]``; tokens past an expert's capacity are dropped,
  * dispatch/combine einsums over the ``[G, T, E, C]`` one-hot tensors,
  * the expert FFNs as one batched quantized einsum each
    (``egcd,edf->egcf`` and ``egcf,efd->egcd``): ``kernels.ops``
    plans them as the int8 matmul kernel's ``[B, M, K] x [B, K, N]`` with
    the experts on B and ``M = G * C``,
  * optional shared experts as a plain dense quantized GLU MLP on every
    token,
  * the Shazeer load-balancing loss and the router z-loss.

The router, softmax/top-k, dispatch, combine and the losses are plain
PyTorch, as the reference computes them with ``jnp`` outside any kernel.
The expert weights are quantized per tensor (one range per site, shared
by all experts: the per-tensor setting the paper studies).

Under data parallelism (``runtime.sharding.data_parallel``) the
load-balance loss takes the global means of ``frac`` and ``prob`` and the
z-loss the global mean, as the reference's global program under GSPMD,
each rank's share of the loss being ``1 / N`` of them; a rank's tokens
must fill whole groups of ``group_size`` (the global program's groups
are then the ranks' in order), or the layer raises.

Under a model group (``runtime.sharding.model_parallel``) a rank holds
``E / M`` experts (``hint(expert_in, "model", "batch", ...)``, the
reference's expert parallelism), or ``sharding.split_range``'s share
where ``M`` does not divide ``E`` (60 experts over 16 ranks: fifteen of
4 and one empty rank, which launches no expert kernel and joins every
collective).  Tokens are replicated over ``model``,
so no all-to-all runs: the dispatch tensor is sliced along E, each rank
runs its experts, and the experts' outputs are gathered along E before
the combine, which every rank then computes whole, as one process does.
A sum of per-rank partial combines would round a token's top-k terms in
another order (bf16 einsums accumulate in fp32 and round once), where
the gather keeps the forward bit for bit; its backward is each rank's
slice of the replicated cotangent, and the dispatch's input gradient,
each rank's partial over its experts, is summed in fp32 (Megatron's f).
The router stays replicated and the shared expert is a Megatron pair;
the aux and z losses are unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import backend, qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.runtime import sharding

from .layers import GLU_KINDS, _GLU_ACT, activation, apply_mlp, init_mlp, \
    init_mlp_sites, init_normal


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden size
    n_shared: int = 0          # shared experts (always on)
    d_shared: int = 0          # shared-expert hidden size (total)
    capacity_factor: float = 2.0
    group_size: int = 512      # tokens per dispatch group
    mlp_kind: str = "swiglu"
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 1e-3

    def capacity(self, group_size: Optional[int] = None) -> int:
        """The reference's float floor division, clamped to ``[4, g]``."""
        g = group_size or self.group_size
        c = int(-(-g * self.top_k * self.capacity_factor // self.n_experts))
        return max(4, min(c, g))


def init_moe(gen: torch.Generator, d_model: int, spec: MoeSpec,
             dtype=torch.float32) -> dict:
    """The reference's shapes and scales; the router is fp32."""
    e, f = spec.n_experts, spec.d_expert
    s_in, s_out = d_model ** -0.5, f ** -0.5
    p = {"router": init_normal(gen, (d_model, e), s_in, torch.float32),
         "w_up": init_normal(gen, (e, d_model, f), s_in, dtype),
         "w_down": init_normal(gen, (e, f, d_model), s_out, dtype)}
    if spec.mlp_kind in GLU_KINDS:
        p["w_gate"] = init_normal(gen, (e, d_model, f), s_in, dtype)
    if spec.n_shared:
        p["shared"] = init_mlp(gen, d_model, spec.d_shared, spec.mlp_kind,
                               use_bias=False, dtype=dtype)
    return p


def init_moe_sites(spec: MoeSpec, device=None) -> dict:
    sites = {"up": qlinear.init_site(device=device),
             "down": qlinear.init_site(device=device)}
    if spec.mlp_kind in GLU_KINDS:
        sites["gate"] = qlinear.init_site(device=device)
    if spec.n_shared:
        sites["shared"] = init_mlp_sites(spec.mlp_kind, device)
    return sites


def _top_k_gating(logits: torch.Tensor, spec: MoeSpec):
    """logits: fp32 ``[G, T, E]``.  Returns ``(gates [G, T, E], aux, z)``;
    ``gates`` is zero outside the selected top-k and renormalized over
    it."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.topk(probs, spec.top_k, dim=-1)        # [G, T, K]
    mask = torch.zeros_like(probs).scatter_(-1, top_idx, 1.0)     # [G, T, E]
    denom = torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9)
    gates = probs * mask / denom

    # Shazeer load-balance loss: E * mean(fraction routed) . mean(prob).
    frac = sharding.dp_mean(mask, (0, 1))
    prob = sharding.dp_mean(probs, (0, 1))
    aux = spec.n_experts * torch.sum(frac * prob)
    z = sharding.dp_mean(torch.logsumexp(logits, dim=-1).square())
    return gates, aux, z


def _dispatch_tensors(gates: torch.Tensor, capacity: int):
    """GShard position-in-expert bookkeeping.

    gates: ``[G, T, E]`` (zero outside top-k).  Returns ``(combine,
    dispatch)``, both ``[G, T, E, C]`` in ``gates``' dtype: the gate weight
    at the token's capacity slot, and 1 there.  A token's slot is its
    position among the group's tokens routed to that expert; tokens past
    the capacity are dropped.  The reference one-hots ``-1`` (an all-zero
    row) for a dropped token; ``F.one_hot`` rejects negative indices, so
    the slot is a comparison with ``arange(C)`` masked by ``keep``."""
    active = (gates > 0).to(torch.int32)                          # [G, T, E]
    pos = torch.cumsum(active, dim=1) - 1                         # in expert
    keep = (active > 0) & (pos < capacity)
    slots = torch.arange(capacity, device=gates.device)
    slot = ((pos[..., None] == slots) & keep[..., None]).to(gates.dtype)
    combine = gates[..., None] * slot
    return combine, slot


def apply_moe(params, sites: dict, x: torch.Tensor, spec: MoeSpec, *,
              policy: QuantPolicy, seed: int, step,
              seq_dim: Optional[int] = None
              ) -> tuple[torch.Tensor, dict, dict]:
    """``x [B, S, D]`` -> ``(y, stats, metrics{aux_loss, z_loss})``.
    ``seq_dim``: ``x`` is the ranks' rows gathered along it and ``y`` this
    rank's rows (the sequence-parallel residual): the routed experts'
    output, whole on every rank after the combine, takes the rows
    (``sharding.mp_take``), and the shared expert's pair
    reduce-scatters."""
    b, s, d = x.shape
    tokens = b * s
    if sharding.dp_shard() is not None and tokens % spec.group_size:
        # the global program's groups are the ranks' in order only when
        # every rank's tokens fill whole groups of the configured size
        raise ValueError(f"a data-parallel rank's {tokens} tokens do not "
                         f"fill whole groups of {spec.group_size}")
    g_size = min(spec.group_size, tokens)
    if tokens % g_size:
        raise ValueError(f"{tokens} tokens do not split into groups of "
                         f"{g_size}")
    n_groups = tokens // g_size
    cap = spec.capacity(g_size)

    xg = x.reshape(n_groups, g_size, d)
    with backend.full_fp32():                                     # fp32 router
        logits = torch.einsum("gtd,de->gte", xg.to(torch.float32),
                              params["router"])
    gates, aux, z = _top_k_gating(logits, spec)
    combine, dispatch = _dispatch_tensors(gates, cap)

    comp = x.dtype
    ep = sharding.mp_shard() is not None
    # a rank's experts: split_range's share (none where the group is
    # wider than the experts' ceil-division leaves it any); the gradient
    # sites' noise is the whole site's, sliced
    par, edim = ("expert", (0, spec.n_experts)) if ep else (None, None)
    # The dispatch in fp32: its forward moves values (one-hot), and its
    # input gradient, a token's top-k slots, is summed in fp32 and rounded
    # once (a bf16 GEMM may round split-K partials to bf16 on the card);
    # under expert parallelism over this rank's experts, the partials
    # summed over the model group (f).
    expert_in = torch.einsum(
        "gtec,gtd->egcd", sharding.mp_slice(dispatch, 2),
        sharding.mp_grad_sum(xg.to(torch.float32))).to(comp)
    # expert parallelism: E over the model axis, groups over data
    expert_in = sharding.hint(expert_in, "model", "batch", None, None)

    new_sites = dict(sites)
    # One shared input quantization for the expert up/gate matmuls (empty
    # capacity slots are zero rows and enter its statistics).
    eq, e_stats, eqi = qlinear.act_quant_site(expert_in, sites["up"]["act"],
                                              policy, step, edim)
    up, s_up = qlinear.qdense_pre(
        eq, params["w_up"], sites["up"], policy,
        einsum_spec="egcd,edf->egcf", seed=seed, step=step, qinfo=eqi,
        batch_dim=1, parallel=par, y_dim=edim)
    if spec.mlp_kind in GLU_KINDS:
        gate, new_sites["gate"] = qlinear.qdense_pre(
            eq, params["w_gate"], sites["gate"], policy,
            einsum_spec="egcd,edf->egcf", seed=seed + 1, step=step,
            qinfo=eqi, batch_dim=1, parallel=par, y_dim=edim)
        h = activation(gate, _GLU_ACT[spec.mlp_kind]) * up
    else:
        h = activation(up, spec.mlp_kind)
    s_up["act"] = e_stats
    new_sites["up"] = s_up
    out, new_sites["down"] = qlinear.qeinsum(
        "egcf,efd->egcd", h, params["w_down"], sites["down"], policy,
        seed=seed + 2, step=step, batch_dim=1, parallel=par, x_dim=edim,
        y_dim=edim)
    if ep:
        out = sharding.mp_gather(out, 0, total=spec.n_experts)

    y = torch.einsum("gtec,egcd->gtd", combine.to(comp), out)
    y = y.reshape(b, s, d)
    if ep and seq_dim is not None:
        y = sharding.mp_take(y, seq_dim)

    if spec.n_shared:
        ys, new_sites["shared"] = apply_mlp(
            params["shared"], sites["shared"], x, spec.mlp_kind, policy,
            seed=seed + 3, step=step, seq_dim=seq_dim)
        y = y + ys

    metrics = {"aux_loss": spec.aux_loss_coef * sharding.dp_share(aux),
               "z_loss": spec.z_loss_coef * sharding.dp_share(z)}
    return y, new_sites, metrics
