"""Deterministic synthetic token stream (resumable, shardable).

Every (step, sample) cell is generated by a counter-based Philox stream, so
any host can materialize exactly its shard of any step without coordination
— the property that makes data-pipeline restart after failure trivial: the
step index *is* the pipeline state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    seed: int = 0
    d_model: int = 0       # >0 -> also emit frontend embeddings
    frontend: str = "none"


class SyntheticTokenDataset:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg

    def batch(self, step: int, start_index: int, count: int
              ) -> Dict[str, np.ndarray]:
        """Samples [start_index, start_index+count) of global step `step`."""
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=c.seed, counter=[0, 0, step, start_index]))
        tokens = rng.integers(0, c.vocab_size,
                              size=(count, c.seq_len + 1), dtype=np.int32)
        out: Dict[str, np.ndarray] = {
            "labels": tokens[:, 1:].copy(),
        }
        if c.frontend != "none":
            out["embeds"] = rng.standard_normal(
                (count, c.seq_len, c.d_model), dtype=np.float32) * 0.02
        else:
            out["tokens"] = tokens[:, :-1].copy()
        return out
