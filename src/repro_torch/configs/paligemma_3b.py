"""paligemma-3b — Google PaliGemma 3B (arXiv:2407.07726; hf).  Port of
``repro/configs/paligemma_3b.py``.

Gemma-2B decoder: 18 layers, d_model 2048, 8 q heads on 1 kv head (MQA),
head_dim 256, d_ff 16384 (GeGLU), vocab 257216, RMSNorm, RoPE, tied
embeddings, sqrt(d) embedding scale.  The SigLIP vision tower is a stub:
256 precomputed patch embeddings of width 1152 through a quantized linear
projector (``patch_proj``); the image prefix attends bidirectionally (the
prefix-LM mask).  Full attention.
"""
import dataclasses

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    source="arXiv:2407.07726; hf",
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    pattern=("attn",),
    frontend_dim=1152,
    n_patches=256,
    loss_chunk=256,
    grad_accum=(("train_4k", 2),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=1, head_dim=16,
        d_ff=128, vocab=512, frontend_dim=24, n_patches=8, loss_chunk=8,
        q_chunk=16, kv_chunk=16, grad_accum=(("train_4k", 1),))


register(CONFIG, reduced)
