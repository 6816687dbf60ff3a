"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B (hf:Qwen/Qwen1.5-MoE-A2.7B; hf).
Port of ``repro/configs/qwen2_moe_a2_7b.py``.

24 layers, d_model 2048, 16 heads (kv=16 -> MHA), head_dim 128, vocab
151936.  MoE FFN: 60 routed experts (top-4, expert d_ff 1408) + a shared
expert block of 5632 (= 4 x 1408), SwiGLU, RMSNorm, RoPE.  Router fp32
(not quantized).  14.31 B parameters, 57.3 GB in fp32.
"""
import dataclasses

from repro_torch.models.moe import MoeSpec

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=1408,               # per-expert hidden (the assigned figure)
    vocab=151936,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1000000.0,
    pattern=("moe",),
    moe=MoeSpec(n_experts=60, top_k=4, d_expert=1408, n_shared=1,
                d_shared=5632, capacity_factor=2.0, group_size=512,
                mlp_kind="swiglu"),
    grad_accum=(("train_4k", 2),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=64, vocab=512, loss_chunk=16, q_chunk=16, kv_chunk=16,
        moe=MoeSpec(n_experts=8, top_k=2, d_expert=64, n_shared=1,
                    d_shared=128, capacity_factor=2.0, group_size=32,
                    mlp_kind="swiglu"),
        grad_accum=(("train_4k", 1),))


register(CONFIG, reduced)
