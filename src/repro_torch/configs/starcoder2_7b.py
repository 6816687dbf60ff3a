"""starcoder2-7b — BigCode StarCoder2 7B (arXiv:2402.19173; hf).  Port of
``repro/configs/starcoder2_7b.py``.

32 layers, d_model 4608, 36 q heads / 4 kv heads (GQA), head_dim 128,
d_ff 18432, vocab 49152, RoPE, learned biases, LayerNorm, gelu MLP,
sliding-window attention w=4096.  The window makes decode O(w) per token
(ring KV cache), so long_500k RUNS for this arch.
"""
import dataclasses

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv=4,
    head_dim=128,
    d_ff=18432,
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
        CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv=2, head_dim=16,
        d_ff=192, vocab=512, sliding_window=16, loss_chunk=16, q_chunk=16,
        kv_chunk=16, grad_accum=(("train_4k", 1),))


register(CONFIG, reduced)
