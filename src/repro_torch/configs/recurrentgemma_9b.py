"""recurrentgemma-9b — Google RecurrentGemma 9B / Griffin (arXiv:2402.19427;
unverified).  Port of ``repro/configs/recurrentgemma_9b.py``.

38 layers in the Griffin 2:1 pattern (rec, rec, local-attn) = 12 full
units + a (rec, rec) tail.  d_model 4096, 16 q heads / 1 kv head (MQA),
head_dim 256, d_ff 12288 (GeGLU), vocab 256000, RG-LRU width 4096, local
attention window 2048, RMSNorm, RoPE on the local-attention blocks, tied
embeddings, sqrt(d) embedding scale.  9.40 B parameters (37.6 GB in
fp32); decode state is constant-size: ``(h, conv_tail)`` per recurrent
block and a 2048-slot ring per local block.
"""
import dataclasses

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    source="arXiv:2402.19427; unverified",
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    pattern=("rec", "rec", "local"),
    local_window=2048,
    lru_width=4096,
    loss_chunk=256,
    grad_accum=(("train_4k", 4),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv=1, head_dim=16,
        d_ff=128, vocab=512, local_window=16, lru_width=64, loss_chunk=16,
        q_chunk=16, kv_chunk=16, grad_accum=(("train_4k", 1),))


register(CONFIG, reduced)
