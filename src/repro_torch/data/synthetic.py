"""Synthetic-but-structured data (numpy; own copies of the JAX package's
generators, so both packages draw the same data from the same seed).

``MarkovLM``: token streams from a sparse random Markov chain — deterministic
in (seed, index), so serving and training runs are reproducible.
``textures_like``: procedural textures for the ResNet (TinyImageNet-shaped
images without a download).
``batches``: the deterministic epoch shuffler of the reference.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MarkovLM", "textures_like", "batches"]


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


def textures_like(n: int, size: int = 32, classes: int = 10,
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(x [n, 3, size, size] float32 in [0, 1], y [n] int32) — class = an
    oriented sinusoid grating and a hue; bitwise the reference's for a
    seed."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    r = np.arange(size)
    xx, yy = np.meshgrid(r, r)
    x = np.empty((n, 3, size, size), np.float32)
    for i in range(n):
        c = int(y[i])
        ang = np.pi * c / classes
        freq = 0.3 + 0.15 * (c % 3)
        phase = rng.uniform(0, 2 * np.pi)
        g = np.sin(freq * (np.cos(ang) * xx + np.sin(ang) * yy) + phase)
        hue = np.array([np.sin(c), np.cos(c), np.sin(2 * c)])[:, None, None]
        img = 0.5 + 0.35 * g[None] * (0.5 + 0.5 * hue)
        img += rng.normal(0, 0.1, (3, size, size))
        x[i] = np.clip(img, 0, 1)
    return x, y


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
    """Deterministic epoch shuffler (the reference's permutation for the
    same seed; a last partial batch is dropped)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    for i in range(0, len(x) - batch_size + 1, batch_size):
        j = idx[i:i + batch_size]
        yield x[j], y[j]
