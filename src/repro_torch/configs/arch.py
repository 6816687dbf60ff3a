"""Architecture configs and the registry (port of
``repro/configs/arch.py``: ``ArchConfig`` and ``register``/``get``/
``get_reduced``/``names``; the dry-run cell matrix and input specs are
JAX-only tools and are not ported)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.models.moe import MoeSpec


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    source: str = ""

    mlp_kind: str = "gelu"
    norm_kind: str = "rmsnorm"
    use_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False
    sliding_window: Optional[int] = None

    pattern: tuple = ("attn",)
    local_window: Optional[int] = None
    lru_width: Optional[int] = None
    rwkv_chunk: int = 32
    moe: Optional[MoeSpec] = None
    enc_pattern: tuple = ("enc",)
    enc_layers: int = 0
    frontend_dim: Optional[int] = None
    n_patches: int = 0

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    q_chunk: int = 2048
    kv_chunk: int = 1024
    dense_attn_max: int = 4096
    loss_chunk: int = 512
    logit_z_coef: float = 0.0
    remat: bool = True

    grad_accum: tuple = (("train_4k", 1),)
    optimizer: str = "adamw"

    def enc_len(self, dec_len: int) -> int:
        """Cross-attention cache length paired with a decoder cache of
        ``dec_len`` (= the encoder sequence the cell feeds)."""
        return dec_len


_REGISTRY: dict = {}


def register(cfg: ArchConfig, reduced: Callable[[], ArchConfig]):
    _REGISTRY[cfg.name] = (cfg, reduced)
    return cfg


def get(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name][0]


def get_reduced(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name][1]()


def names() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if not _REGISTRY:
        from . import moonshot_v1_16b_a3b, qwen2_moe_a2_7b  # noqa: F401
        from . import command_r_35b, nemotron_4_340b  # noqa: F401
        from . import recurrentgemma_9b, rwkv6_7b  # noqa: F401
        from . import starcoder2_3b, starcoder2_7b  # noqa: F401
        from . import paligemma_3b, seamless_m4t_medium  # noqa: F401
