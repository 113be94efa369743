# Copied from src/repro/data/pipeline.py; only the repro. imports are rewritten.
"""Deterministic, resumable token pipeline for the trainer.

The trainer's input plane: synthetic-but-deterministic token streams (no
dataset downloads offline) sharded by (host, data-shard), with an explicit
iterator state that is checkpointed into OffloadDB alongside the model, so
a restarted (or re-scaled) job resumes exactly where it left off —
elasticity support per DESIGN.md §5.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class PipelineState:
    step: int = 0
    shard: int = 0
    num_shards: int = 1
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @classmethod
    def from_json(cls, s: str) -> "PipelineState":
        return cls(**json.loads(s))


class TokenPipeline:
    """Deterministic LM batches: batch (B, S) int32 tokens + next-token
    labels. Same (seed, shard, step) → same batch, independent of the
    number of shards at *other* steps (elastic re-sharding safe)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 *, state: Optional[PipelineState] = None):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.state = state or PipelineState()

    def _gen(self, step: int, shard: int) -> np.ndarray:
        # counter-based generation → O(1) resume at any step
        rng = np.random.RandomState(
            (self.state.seed * 1_000_003 + step * 8191 + shard) % (2**31 - 1)
        )
        # zipfian-ish token distribution (structured, not uniform noise)
        u = rng.rand(self.batch, self.seq + 1)
        toks = (self.vocab * (u**3)).astype(np.int32) % self.vocab
        return toks

    def next_batch(self) -> Dict[str, np.ndarray]:
        toks = self._gen(self.state.step, self.state.shard)
        self.state.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def reshard(self, shard: int, num_shards: int) -> None:
        """Elastic re-scale: keep the step counter, change shard identity."""
        self.state.shard = shard
        self.state.num_shards = num_shards
