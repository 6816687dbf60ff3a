"""Architecture configs: dataclass, shape matrix, registry, input specs
(port of ``repro/configs/arch.py``).

Every architecture registers an :class:`ArchConfig` (the figures of the
public source cited in its module) and a ``reduced()`` variant for the
CPU tests.

The shape matrix:

    train_4k      seq 4096    global_batch 256   -> train_step
    prefill_32k   seq 32768   global_batch 32    -> prefill_step
    decode_32k    seq 32768   global_batch 128   -> decode_step (1 new token)
    long_500k     seq 524288  global_batch 1     -> decode_step

``long_500k`` requires sub-quadratic attention: it runs for rwkv6
(attention-free), recurrentgemma (RG-LRU + local attention) and the
starcoder2 pair (sliding window 4096 -> a constant-size ring KV cache),
and is skipped for the pure full-attention archs (``Cell.skip_reason``).
:func:`input_specs` gives a cell's model inputs as meta tensors: names,
shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models.moe import MoeSpec


# ---------------------------------------------------------------------------
# Shapes.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# ArchConfig.
# ---------------------------------------------------------------------------

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

    def grad_accum_for(self, shape_name: str) -> int:
        return dict(self.grad_accum).get(shape_name, 1)

    def enc_len(self, dec_len: int) -> int:
        """Cross-attention cache length paired with a decoder cache of
        ``dec_len`` (= the encoder sequence the cell feeds)."""
        return dec_len

    @property
    def sub_quadratic(self) -> bool:
        if self.family in ("rwkv", "hybrid"):
            return True
        return self.sliding_window is not None

    def supports(self, shape_name: str) -> tuple[bool, str]:
        if shape_name == "long_500k" and not self.sub_quadratic:
            return False, ("full attention: 512k decode needs an O(S) KV "
                           "cache per token; skipped per assignment rules")
        return True, ""


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


# ---------------------------------------------------------------------------
# Cells: the (arch x shape) matrix.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    runnable: bool
    skip_reason: str = ""


def cells() -> list:
    _ensure_loaded()
    out = []
    for a in names():
        cfg = get(a)
        for s in SHAPES:
            ok, why = cfg.supports(s)
            out.append(Cell(a, s, ok, why))
    return out


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation).
# ---------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Model inputs for one cell, as meta tensors (shape and dtype, no
    storage).

    For train/prefill, ``tokens`` spans the full seq_len (VLM: image prefix
    + text fills seq_len; enc-dec: encoder frames at seq_len, decoder
    tokens at seq_len for train / 1 for prefill)."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    comp = cfg.compute_dtype

    if shape.kind == "train":
        if cfg.family == "encdec":
            return {
                "frames": _spec((b, s, cfg.frontend_dim), comp),
                "tokens": _spec((b, s), i32),
                "labels": _spec((b, s), i32),
                "mask": _spec((b, s), f32),
            }
        if cfg.family == "vlm":
            st = s - cfg.n_patches
            return {
                "patches": _spec((b, cfg.n_patches, cfg.frontend_dim), comp),
                "tokens": _spec((b, st), i32),
                "labels": _spec((b, st), i32),
                "mask": _spec((b, st), f32),
            }
        return {
            "tokens": _spec((b, s), i32),
            "labels": _spec((b, s), i32),
            "mask": _spec((b, s), f32),
        }

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": _spec((b, s, cfg.frontend_dim), comp),
                    "tokens": _spec((b, 1), i32)}
        if cfg.family == "vlm":
            return {"patches": _spec((b, cfg.n_patches, cfg.frontend_dim),
                                     comp),
                    "tokens": _spec((b, s - cfg.n_patches), i32)}
        return {"tokens": _spec((b, s), i32)}

    # decode: one new token against a cache of length seq_len.
    return {"token": _spec((b, 1), i32), "pos": _spec((b,), i32)}
