"""starcoder2-3b — BigCode StarCoder2 3B (arXiv:2402.19173; hf).  Port of
``repro/configs/starcoder2_3b.py``.

30 layers, d_model 3072, 24 q heads / 2 kv heads, head_dim 128, d_ff 12288,
vocab 49152, RoPE theta 1e5, biases, LayerNorm, tanh-gelu, sliding window
4096.
"""
import dataclasses

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv=2,
    head_dim=128,
    d_ff=12288,
    vocab=49152,
    source="arXiv:2402.19173; hf",
    mlp_kind="gelu",
    norm_kind="layernorm",
    use_bias=True,
    rope_theta=100000.0,
    sliding_window=4096,
    pattern=("attn",),
    grad_accum=(("train_4k", 4),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512, sliding_window=16, loss_chunk=16, q_chunk=16,
        kv_chunk=16, grad_accum=(("train_4k", 1),))


register(CONFIG, reduced)
