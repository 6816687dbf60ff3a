"""Block-size selection for the CUDA kernels (port of
``repro/kernels/tuning.py``).

One function per kernel family:

    ``matmul_block(m, n, k)``        -> (bm, bn, bk) for ``ops.int8_matmul_fp``,
                                        ``ops.int8_conv_fp`` and
                                        ``ops.int8_matmul_fused``
    ``attention_block(sq, skv, hd)`` -> (bq, bkv) for the attention core

Selection is **heuristic by default** (minimise tile padding waste over a
fixed candidate list, ties keeping the default first candidate, so shapes
keep their schedule) and optionally **benchmark-driven**:

    REPRO_TUNE=benchmark      time each candidate once per (kind, shape,
                              dtype) through the caller's thunk and cache
                              the winner for the process
    REPRO_TUNE=heuristic      the default (no timing)

Hard overrides, checked before the cache:

    REPRO_MM_BLOCK="bm,bn,bk"     pin the matmul tile
    REPRO_ATTN_BLOCK="bq,bkv"     pin the attention tile

The matmul tile is parity-neutral: the int32 contraction is exact in any
order, so a tile changes speed, never results.  The CUDA matmul
instantiates the row tiles of :data:`MATMUL_TILES` (``BN = BK = 128``);
the full tiles among them are the candidates, and a pin must name one of
the instantiated tiles.  Where M is below the chosen ``bm`` the launch
runs the least instantiated row tile that covers M
(``int8_matmul.row_tile``), the counterpart of the Pallas block's clamp
``min(bm, M)`` that :func:`_padding_waste` models.

The attention tile CHANGES THE RESULTS: the probabilities are quantized
against the running max at each kv block, so the port picks exactly the
reference's ``(bq, bkv)``, by the same heuristic over the same candidate
list.

The benchmark mode fences each timed run on the device
(``torch.cuda.synchronize`` before each clock read once CUDA is in use),
so it times the kernels and not their enqueue.  No call site of the port
passes a thunk, as none of the reference's does: the mode is for a caller
that times its own launches.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

MATMUL_DEFAULT = (128, 128, 128)
ATTN_DEFAULT = (128, 128)

# Every tile the CUDA matmul instantiates: the full tiles, then the row
# clamps 32 and 16 (mma.sync's m16 is the least row tile).
MATMUL_TILES: Tuple[Tuple[int, int, int], ...] = (
    MATMUL_DEFAULT,
    (64, 128, 128),
    (32, 128, 128),
    (16, 128, 128),
)
# The candidates: the full tiles, default first.  The row clamps are not
# candidates: under the padding heuristic a 16-row tile would win at the
# MoE prefill's M = 552 and re-read every weight slab once per 16 rows.
MATMUL_CANDIDATES: Tuple[Tuple[int, int, int], ...] = MATMUL_TILES[:2]
ATTN_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    ATTN_DEFAULT,
    (64, 64),
    (64, 128),
    (128, 64),
    (256, 128),
)

# (kind, shape, dtype) -> chosen block.  Process-lifetime cache: the
# choice is stable within a run.
_CACHE: Dict[tuple, tuple] = {}

# The benchmark mode's clock.
_clock = time.perf_counter


def clear_cache() -> None:
    _CACHE.clear()


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


def _fence() -> None:
    """Wait for the device's queued work, where CUDA is in use, so a clock
    read after it sees the kernels end and not their enqueue."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _benchmark(candidates, thunk: Callable[[tuple], Callable[[], None]],
               default) -> tuple:
    best, best_t = default, float("inf")
    for cand in candidates:
        try:
            run = thunk(cand)
            run()  # warmup (and the kernels' build)
            _fence()
            t0 = _clock()
            run()
            _fence()
            dt = _clock() - t0
        except Exception:  # tile invalid for this shape — skip
            continue
        if dt < best_t:
            best, best_t = cand, dt
    return best


def _select(kind: str, dims: tuple, dtype, candidates, default,
            bench_thunk: Optional[Callable] = None) -> tuple:
    key = (kind, dims, str(dtype))
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    mode = os.environ.get("REPRO_TUNE", "heuristic").strip().lower()
    if mode == "benchmark" and bench_thunk is not None:
        choice = _benchmark(candidates, bench_thunk, default)
    else:
        choice = _heuristic(dims, candidates, default)
    _CACHE[key] = choice
    return choice


def matmul_block(m: int, n: int, k: int, dtype="int8",
                 bench_thunk: Optional[Callable] = None
                 ) -> Tuple[int, int, int]:
    """Tile for the int8 matmuls.  Env ``REPRO_MM_BLOCK`` wins, and must
    name one of :data:`MATMUL_TILES`."""
    override = _parse_env("REPRO_MM_BLOCK", 3)
    if override is not None:
        if override not in MATMUL_TILES:
            raise ValueError(
                f"REPRO_MM_BLOCK={override} is not a tile the CUDA matmul "
                f"instantiates; the tiles are {MATMUL_TILES}")
        return override
    return _select("matmul", (m, n, k), dtype, MATMUL_CANDIDATES,
                   MATMUL_DEFAULT, bench_thunk)


def attention_block(sq: int, skv: int, hd: int, dtype="int8",
                    bench_thunk: Optional[Callable] = None
                    ) -> Tuple[int, int]:
    """(bq, bkv) for the attention core.  Env ``REPRO_ATTN_BLOCK`` wins.
    The choice is made once at dispatch and shared by both backends (the
    simulated core replays the same block schedule)."""
    override = _parse_env("REPRO_ATTN_BLOCK", 2)
    if override is not None:
        return override
    return _select("attention", (sq, skv, hd), dtype, ATTN_CANDIDATES,
                   ATTN_DEFAULT, bench_thunk)
