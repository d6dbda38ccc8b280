"""Deterministic synthetic LM data.

Markov-chain token streams with a fixed transition structure so a ~100M model
shows a real, reproducible loss curve (the chain's conditional entropy is the
loss floor). Batches are a pure function of (seed, step, shard) — the
straggler/elastic property the framework needs: any host can regenerate any
shard after a restart or re-balance with no data reshuffle (the policy of
``training/elastic.py``). The port's copy of the JAX package's module
(numpy only): the same arrays for the same arguments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4          # candidate successors per token (entropy knob)
    num_shards: int = 1
    shard: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, B = self.vocab_size, self.branching
        self.successors = rng.integers(0, V, size=(V, B), dtype=np.int32)
        probs = rng.dirichlet(np.ones(B) * 2.0, size=V).astype(np.float32)
        self.cum_probs = np.cumsum(probs, axis=-1)

    @property
    def entropy_floor(self) -> float:
        """Mean conditional entropy (nats) — the achievable loss floor."""
        p = np.diff(np.concatenate(
            [np.zeros((self.vocab_size, 1), np.float32), self.cum_probs], 1))
        p = np.clip(p, 1e-9, 1.0)
        return float(-(p * np.log(p)).sum(-1).mean())

    def _walk(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n + 1, np.int32)
        out[0] = rng.integers(0, self.vocab_size)
        u = rng.random(n).astype(np.float32)
        for t in range(n):
            row = out[t]
            b = int(np.searchsorted(self.cum_probs[row], u[t]))
            b = min(b, self.branching - 1)
            out[t + 1] = self.successors[row, b]
        return out

    def batch(self, step: int) -> dict:
        """Batch for ``step`` on this shard: {tokens, labels} (B_shard, S)."""
        assert self.global_batch % self.num_shards == 0
        b_shard = self.global_batch // self.num_shards
        toks = np.empty((b_shard, self.seq_len), np.int32)
        labs = np.empty((b_shard, self.seq_len), np.int32)
        for i in range(b_shard):
            seq_id = step * self.global_batch + self.shard * b_shard + i
            rng = np.random.default_rng((self.seed, seq_id))
            walk = self._walk(rng, self.seq_len)
            toks[i] = walk[:-1]
            labs[i] = walk[1:]
        return {"tokens": toks, "labels": labs}


def make_batch_iterator(ds: SyntheticLMDataset, start_step: int = 0,
                        microbatches: int = 1) -> Iterator[dict]:
    """Restart-stable iterator; with microbatches>1 leaves are
    (mb, B/mb, ...) matching the trainer layout."""
    step = start_step
    while True:
        b = ds.batch(step)
        if microbatches > 1:
            b = {k: v.reshape(microbatches, -1, *v.shape[1:])
                 for k, v in b.items()}
        yield b
        step += 1
