"""moonshot-v1-16b-a3b — Moonlight-16B-A3B (hf:moonshotai/Moonlight-16B-A3B;
hf).  Port of ``repro/configs/moonshot_v1_16b_a3b.py``.

48 layers (assigned figure), d_model 2048, 16 heads (kv=16), head_dim 128,
vocab 163840.  MoE FFN: 64 routed experts top-6 (expert d_ff 1408) + 2
shared experts (2 x 1408 = 2816), SwiGLU, RMSNorm, RoPE.  28.9 B
parameters, 115.6 GB in fp32: more than one 80 GB card holds.
"""
import dataclasses

from repro_torch.models.moe import MoeSpec

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=50000.0,
    pattern=("moe",),
    moe=MoeSpec(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                d_shared=2816, capacity_factor=2.0, group_size=512,
                mlp_kind="swiglu"),
    grad_accum=(("train_4k", 4),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=64, vocab=512, loss_chunk=16, q_chunk=16, kv_chunk=16,
        moe=MoeSpec(n_experts=8, top_k=2, d_expert=64, n_shared=2,
                    d_shared=128, capacity_factor=2.0, group_size=32,
                    mlp_kind="swiglu"),
        grad_accum=(("train_4k", 1),))


register(CONFIG, reduced)
