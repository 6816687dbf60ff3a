"""seamless-m4t-medium — Meta SeamlessM4T medium (arXiv:2308.11596; hf).
Port of ``repro/configs/seamless_m4t_medium.py``.

Encoder-decoder, d_model 1024, 16 heads (MHA: n_kv 16), head_dim 64,
d_ff 4096, vocab 256206, LayerNorm with biases, tanh-gelu, RoPE.  12
encoder + 12 decoder layers; the speech frontend is a stub: precomputed
frame embeddings of width 160, projected by a quantized linear
(``enc_in``).  Full attention.
"""
import dataclasses

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder layers
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    source="arXiv:2308.11596; hf",
    mlp_kind="gelu",
    norm_kind="layernorm",
    use_bias=True,
    rope_theta=10000.0,
    pattern=("xattn",),
    enc_pattern=("enc",),
    frontend_dim=160,
    grad_accum=(("train_4k", 2),),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv=4,
        head_dim=16, d_ff=128, vocab=512, frontend_dim=16, loss_chunk=16,
        q_chunk=16, kv_chunk=16, grad_accum=(("train_4k", 1),))


register(CONFIG, reduced)
