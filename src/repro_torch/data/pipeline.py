"""Deterministic synthetic LM batches (port of ``repro/data/pipeline.py``,
``LMStream`` and ``for_arch``).

A fixed random Markov chain over the vocabulary (``branch`` successors per
token) walked from a random start, keyed only by ``(seed, step, shard)``.
The port draws from its own ``torch.Generator`` (CPU, so the stream is the
same whichever device later holds it); it cannot reproduce the
reference's threefry stream, so parity tests feed the same tokens to both.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LMStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4

    def _generator(self, *key: int) -> torch.Generator:
        mixed = 0
        for k in key:
            mixed = (mixed * 1_000_003 + int(k)) % (2 ** 63 - 1)
        return torch.Generator().manual_seed(mixed)

    def _table(self) -> torch.Tensor:
        """vocab x branch successor table (fixed by the task seed)."""
        g = self._generator(self.seed)
        return torch.randint(0, self.vocab, (self.vocab, self.branch),
                             generator=g)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """``{"tokens", "labels", "mask"}`` for one step (CPU tensors)."""
        if self.global_batch % num_shards:
            raise ValueError("global_batch must divide into the shards")
        per_shard = self.global_batch // num_shards
        table = self._table()
        g = self._generator(self.seed + 1, step, shard)
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


def for_arch(cfg, seq_len: int, global_batch: int, seed: int = 0):
    """Stream matching an ArchConfig's batch convention (dense LMs)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.family} streams come with that model family's slice")
    return LMStream(cfg.vocab, seq_len, global_batch, seed)
