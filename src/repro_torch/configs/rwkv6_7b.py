"""rwkv6-7b — RWKV-6 "Finch" 7B (arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b).
Port of ``repro/configs/rwkv6_7b.py``.

32 layers, d_model 4096 (64 heads x 64), attention-free (WKV recurrence
with data-dependent decay), channel-mix FFN 14336, vocab 65536 (World),
untied embed and head.  7.577 B parameters (30.3 GB in fp32); the decode
state is constant-size: the [64, 64] WKV state per head and the two
token-shift rows per layer.
"""
import dataclasses

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # head_dim 64 (RWKV convention)
    n_kv=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    source="arXiv:2404.05892; hf",
    mlp_kind="relu",       # channel-mix uses relu^2 internally
    norm_kind="layernorm",
    use_bias=False,
    rope_theta=None,       # no positional rotation; recurrence is ordered
    pattern=("rwkv",),
    rwkv_chunk=32,
    grad_accum=(("train_4k", 4),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=512, rwkv_chunk=8, loss_chunk=16, q_chunk=16,
        kv_chunk=16, grad_accum=(("train_4k", 1),))


register(CONFIG, reduced)
