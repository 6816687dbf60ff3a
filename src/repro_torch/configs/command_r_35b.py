"""command-r-35b — Cohere Command-R v01 (hf:CohereForAI/c4ai-command-r-v01;
unverified).  Port of ``repro/configs/command_r_35b.py``.

40 layers, d_model 8192, 64 q heads / 8 kv heads, head_dim 128, d_ff 22528,
vocab 256000, SwiGLU, LayerNorm without bias, RoPE, no linear biases, tied
embeddings.  Full attention: long_500k skipped.
"""
import dataclasses

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    mlp_kind="swiglu",
    norm_kind="layernorm",
    use_bias=False,
    rope_theta=10000.0,
    tie_embeddings=True,
    pattern=("attn",),
    loss_chunk=256,
    grad_accum=(("train_4k", 8),),
    optimizer="sgdm",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=160, vocab=512, loss_chunk=16, q_chunk=16, kv_chunk=16,
        grad_accum=(("train_4k", 1),))


register(CONFIG, reduced)
