"""Attention block-size selection (port of ``repro/kernels/tuning.py``).

The attention tile CHANGES THE RESULTS: the probabilities are quantized
against the running max at each kv block, so the port must pick exactly
the reference's ``(bq, bkv)``.  This is the reference's padding-waste
heuristic over the same candidate list (ties keep the historical default)
with the same ``REPRO_ATTN_BLOCK="bq,bkv"`` override.

The matmul tile is parity-neutral (exact int32 arithmetic), so the CUDA
matmul picks its own; the reference's ``matmul_block`` and its
``REPRO_TUNE=benchmark`` mode are not ported.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

ATTN_DEFAULT = (128, 128)
ATTN_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    ATTN_DEFAULT,
    (64, 64),
    (64, 128),
    (128, 64),
    (256, 128),
)


def _parse_env(name: str, arity: int) -> Optional[tuple]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    parts = [p for p in raw.replace(",", " ").split() if p]
    if len(parts) != arity:
        raise ValueError(
            f"{name} must be {arity} comma-separated ints, got {raw!r}")
    vals = tuple(int(p) for p in parts)
    if any(v <= 0 for v in vals):
        raise ValueError(f"{name} entries must be positive, got {raw!r}")
    return vals


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _padding_waste(dims: Sequence[int], block: Sequence[int]) -> float:
    """Fraction of padded tile volume that is outside the real operand."""
    full = 1.0
    padded = 1.0
    for d, b in zip(dims, block):
        eb = min(b, d) if d > 0 else b
        full *= max(d, 1)
        padded *= _cdiv(max(d, 1), eb) * eb
    return (padded - full) / padded


def _heuristic(dims: Sequence[int], candidates, default) -> tuple:
    best = default
    best_waste = _padding_waste(dims, default)
    for cand in candidates:
        w = _padding_waste(dims, cand)
        if w < best_waste - 1e-12:       # strict: ties keep the default
            best, best_waste = cand, w
    return best


def attention_block(sq: int, skv: int, hd: int) -> Tuple[int, int]:
    """(bq, bkv) for the attention core; ``REPRO_ATTN_BLOCK`` wins."""
    override = _parse_env("REPRO_ATTN_BLOCK", 2)
    if override is not None:
        return override
    return _heuristic((sq, skv, hd), ATTN_CANDIDATES, ATTN_DEFAULT)
