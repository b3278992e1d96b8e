"""Synthetic-but-structured token data (numpy; own copy of the JAX package's
``MarkovLM`` so both packages draw the same prompts from the same seed).

``MarkovLM``: token streams from a sparse random Markov chain — deterministic
in (seed, index), so serving and training runs are reproducible.
``batches``: the deterministic epoch shuffler of the reference.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MarkovLM", "batches"]


class MarkovLM:
    """Sparse random Markov chain over ``vocab`` tokens; branching ``k``."""

    def __init__(self, vocab: int = 512, k: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.succ = rng.integers(0, vocab, size=(vocab, k))
        logits = rng.standard_normal((vocab, k))
        p = np.exp(logits)
        self.p = p / p.sum(1, keepdims=True)
        self.entropy = float(-(self.p * np.log(self.p)).sum(1).mean())

    def sample(self, batch: int, seq_len: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng((seed, 7919))
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        for t in range(seq_len):
            cur = toks[:, t]
            choice = (rng.random(batch)[:, None] < np.cumsum(self.p[cur], 1)).argmax(1)
            toks[:, t + 1] = self.succ[cur, choice]
        return toks

    def batch(self, batch: int, seq_len: int, seed: int) -> dict:
        toks = self.sample(batch, seq_len, seed)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
    """Deterministic epoch shuffler (the reference's permutation for the
    same seed; a last partial batch is dropped)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    for i in range(0, len(x) - batch_size + 1, batch_size):
        j = idx[i:i + batch_size]
        yield x[j], y[j]
