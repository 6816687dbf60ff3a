"""nemotron-4-340b — NVIDIA Nemotron-4 340B (arXiv:2402.16819; unverified).
Port of ``repro/configs/nemotron_4_340b.py``.

96 layers, d_model 18432, 96 q heads / 8 kv heads (GQA), head_dim 192,
d_ff 73728, vocab 256000, squared-ReLU MLP, LayerNorm, RoPE, no biases.
The scale test of the pool: ~340B params — trains only with 2D-sharded
(fsdp x tensor) parameters + optimizer state, 16-way gradient
accumulation and full block remat.  Full attention: long_500k skipped.
"""
import dataclasses

from .arch import ArchConfig, register

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    source="arXiv:2402.16819; unverified",
    mlp_kind="sq_relu",
    norm_kind="layernorm",
    use_bias=False,
    rope_theta=10000.0,
    pattern=("attn",) * 4,   # 4-layer remat group: 24 saved
    # residuals instead of 96 (activation memory / 4 at 2x recompute cost)
    loss_chunk=256,
    grad_accum=(("train_4k", 8),),
    optimizer="sgdm",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv=2, head_dim=16,
        d_ff=384, vocab=512, loss_chunk=16, q_chunk=16, kv_chunk=16,
        grad_accum=(("train_4k", 2),))


register(CONFIG, reduced)
