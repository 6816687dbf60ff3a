"""Deterministic synthetic batches (port of ``repro/data/pipeline.py``:
``LMStream``, ``FrontendLMStream``, ``ImageStream`` and ``for_arch``).

``LMStream``: a fixed random Markov chain over the vocabulary (``branch``
successors per token) walked from a random start.  ``FrontendLMStream``:
an ``LMStream`` batch plus the stub frontend's features (audio frames of
the enc-dec family, image patches of the VLM family), standard normal
plus ``0.1 * (first token % 7)`` so the frontend carries signal.
``ImageStream``: the
paper's CNN family's classification stream, a fixed random pattern per
class plus noise.  Both are keyed only by ``(seed, step, shard)``.  The
port draws from its own ``torch.Generator`` (CPU, so a stream is the same
whichever device later holds it); it cannot reproduce the reference's
threefry stream, so parity tests feed the same batches to both.
"""
from __future__ import annotations

import dataclasses
import functools

import torch


def _generator(*key: int) -> torch.Generator:
    mixed = 0
    for k in key:
        mixed = (mixed * 1_000_003 + int(k)) % (2 ** 63 - 1)
    return torch.Generator().manual_seed(mixed)


@dataclasses.dataclass(frozen=True)
class LMStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4

    def _table(self) -> torch.Tensor:
        """vocab x branch successor table (fixed by the task seed)."""
        g = _generator(self.seed)
        return torch.randint(0, self.vocab, (self.vocab, self.branch),
                             generator=g)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """``{"tokens", "labels", "mask"}`` for one step (CPU tensors)."""
        if self.global_batch % num_shards:
            raise ValueError("global_batch must divide into the shards")
        per_shard = self.global_batch // num_shards
        table = self._table()
        g = _generator(self.seed + 1, step, shard)
        start = torch.randint(0, self.vocab, (per_shard,), generator=g)
        choices = torch.randint(0, self.branch, (per_shard, self.seq_len + 1),
                                generator=g)
        seq = [start]
        tok = start
        for j in range(self.seq_len):
            tok = table[tok, choices[:, j]]
            seq.append(tok)
        seq = torch.stack(seq, dim=1)                      # [B, S+1]
        tokens = seq[:, :self.seq_len]
        labels = seq[:, 1:self.seq_len + 1]
        return {"tokens": tokens, "labels": labels,
                "mask": torch.ones_like(labels, dtype=torch.float32)}


@dataclasses.dataclass(frozen=True)
class FrontendLMStream:
    lm: LMStream
    frontend_dim: int
    frontend_len: int        # frames (enc-dec) or patches (VLM)
    kind: str = "frames"     # "frames" | "patches"

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """The ``LMStream`` batch plus ``kind``: fp32 ``[B, frontend_len,
        frontend_dim]`` (CPU)."""
        b = self.lm.batch(step, shard, num_shards)
        per_shard = b["tokens"].shape[0]
        g = _generator(self.lm.seed + 77, step * 131 + shard)
        feats = torch.randn((per_shard, self.frontend_len,
                             self.frontend_dim), generator=g)
        phase = (b["tokens"][:, :1, None] % 7).to(torch.float32)
        b[self.kind] = feats + 0.1 * phase
        return b


@functools.lru_cache(maxsize=4)
def _class_basis(seed: int, num_classes: int, image_size: int,
                 channels: int) -> torch.Tensor:
    """The fixed per-class pattern ``[classes, S, S, C]`` of a stream."""
    return torch.randn((num_classes, image_size, image_size, channels),
                       generator=_generator(seed + 13))


@dataclasses.dataclass(frozen=True)
class ImageStream:
    """Synthetic classification batches: ``0.6 * basis[label] + noise``
    with a standard-normal basis fixed by the seed, NHWC fp32 images."""

    num_classes: int
    image_size: int
    channels: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """``{"images" [B, S, S, C] fp32, "labels" [B] int64}`` (CPU)."""
        if self.global_batch % num_shards:
            raise ValueError("global_batch must divide into the shards")
        per_shard = self.global_batch // num_shards
        g = _generator(self.seed, step, shard)
        labels = torch.randint(0, self.num_classes, (per_shard,), generator=g)
        noise = torch.randn((per_shard, self.image_size, self.image_size,
                             self.channels), generator=g)
        signal = _class_basis(self.seed, self.num_classes, self.image_size,
                              self.channels)[labels]
        return {"images": 0.6 * signal + noise, "labels": labels}


def for_arch(cfg, seq_len: int, global_batch: int, seed: int = 0):
    """Stream matching an ArchConfig's batch convention: enc-dec batches
    carry ``seq_len`` frames beside ``seq_len`` tokens; VLM batches
    ``n_patches`` patches and ``seq_len - n_patches`` tokens."""
    if cfg.family == "encdec":
        lm = LMStream(cfg.vocab, seq_len, global_batch, seed)
        return FrontendLMStream(lm, cfg.frontend_dim, seq_len, "frames")
    if cfg.family == "vlm":
        lm = LMStream(cfg.vocab, seq_len - cfg.n_patches, global_batch, seed)
        return FrontendLMStream(lm, cfg.frontend_dim, cfg.n_patches,
                                "patches")
    return LMStream(cfg.vocab, seq_len, global_batch, seed)
