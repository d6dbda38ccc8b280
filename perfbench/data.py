"""The train cell's batches: the benchmark's copy of the port's
``data/synthetic.py`` ``SyntheticLMDataset`` (Markov-chain token streams,
numpy only): a batch is a pure function of (seed, step)."""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int,
                 branching: int = 4):
        self.V, self.S, self.B, self.seed = vocab_size, seq_len, batch, seed
        self.branching = branching
        rng = np.random.default_rng(seed)
        self.successors = rng.integers(0, vocab_size,
                                       size=(vocab_size, branching),
                                       dtype=np.int32)
        probs = rng.dirichlet(np.ones(branching) * 2.0,
                              size=vocab_size).astype(np.float32)
        self.cum_probs = np.cumsum(probs, axis=-1)

    def _walk(self, rng, n: int) -> np.ndarray:
        out = np.empty(n + 1, np.int32)
        out[0] = rng.integers(0, self.V)
        u = rng.random(n).astype(np.float32)
        for t in range(n):
            row = out[t]
            b = min(int(np.searchsorted(self.cum_probs[row], u[t])),
                    self.branching - 1)
            out[t + 1] = self.successors[row, b]
        return out

    def batch(self, step: int) -> dict:
        """``{"tokens", "labels"}``, each (batch, seq_len) int32; the rows
        of every step differ."""
        toks = np.empty((self.B, self.S), np.int32)
        labs = np.empty((self.B, self.S), np.int32)
        for i in range(self.B):
            rng = np.random.default_rng((self.seed, step * self.B + i))
            walk = self._walk(rng, self.S)
            toks[i], labs[i] = walk[:-1], walk[1:]
        return {"tokens": toks, "labels": labs}
