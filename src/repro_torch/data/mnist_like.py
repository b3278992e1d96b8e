"""MNIST-scale stroke digits (no internet in this container, so no real
MNIST download; this is the closest procedural stand-in).

Unlike ``synthetic.digits_like`` (rigid 7-segment glyphs), these digits are
rendered from per-class *stroke skeletons* — polylines and elliptical arcs in
a unit box — passed through a random affine (rotation, anisotropic scale,
shear, translation) and drawn with a soft Gaussian brush plus pixel noise.
The result has the properties the paper's MLP experiment needs from MNIST:
28x28 grayscale, 10 classes, large intra-class variation with smooth strokes,
and enough difficulty that regularization/pruning measurably moves accuracy.

Deterministic in ``seed`` (restart-reproducible input pipelines).  This
package's own copy of ``repro.data.mnist_like``: the same seed gives the same
arrays bit for bit.
"""
from __future__ import annotations

import numpy as np

__all__ = ["mnist_like", "train_test"]


def _line(p0, p1, n=18):
    t = np.linspace(0.0, 1.0, n)[:, None]
    return (1 - t) * np.asarray(p0, float) + t * np.asarray(p1, float)


def _arc(c, rx, ry, a0_deg, a1_deg, n=26):
    a = np.radians(np.linspace(a0_deg, a1_deg, n))
    cx, cy = c
    return np.stack([cx + rx * np.cos(a), cy + ry * np.sin(a)], axis=1)


# stroke skeletons per digit, (x, y) in a unit box with y pointing DOWN
_STROKES = {
    0: [_arc((0.5, 0.5), 0.27, 0.37, 0, 360, 48)],
    1: [_line((0.36, 0.30), (0.54, 0.13)), _line((0.54, 0.13), (0.54, 0.87)),
        _line((0.38, 0.87), (0.68, 0.87), 10)],
    2: [_arc((0.5, 0.32), 0.24, 0.19, 180, 355, 30),
        _line((0.72, 0.38), (0.27, 0.84)),
        _line((0.27, 0.84), (0.76, 0.84), 14)],
    3: [_arc((0.47, 0.31), 0.22, 0.17, 160, 380, 26),
        _arc((0.47, 0.66), 0.25, 0.21, -70, 170, 28)],
    4: [_line((0.66, 0.12), (0.24, 0.60)), _line((0.24, 0.60), (0.80, 0.60)),
        _line((0.66, 0.34), (0.66, 0.88))],
    5: [_line((0.72, 0.14), (0.32, 0.14), 12), _line((0.32, 0.14), (0.30, 0.45)),
        _arc((0.47, 0.64), 0.25, 0.22, -100, 130, 30)],
    6: [_arc((0.62, 0.25), 0.45, 0.55, 115, 180, 20),
        _arc((0.48, 0.66), 0.22, 0.21, 0, 360, 36)],
    7: [_line((0.24, 0.15), (0.76, 0.15), 14), _line((0.76, 0.15), (0.40, 0.88)),
        _line((0.38, 0.52), (0.64, 0.52), 8)],
    8: [_arc((0.5, 0.31), 0.19, 0.17, 0, 360, 30),
        _arc((0.5, 0.68), 0.23, 0.20, 0, 360, 34)],
    9: [_arc((0.5, 0.34), 0.21, 0.20, 0, 360, 32),
        _arc((0.40, 0.55), 0.32, 0.36, -25, 65, 18)],
}


def _render(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Affine-jitter stroke points and splat them with a soft brush -> 28x28."""
    ang = np.radians(rng.uniform(-12.0, 12.0))
    sx, sy = rng.uniform(0.82, 1.12, 2)
    shear = rng.uniform(-0.15, 0.15)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    aff = rot @ np.array([[sx, shear * sx], [0.0, sy]])
    centered = points - 0.5
    pts = centered @ aff.T + 0.5 + rng.uniform(-0.07, 0.07, 2)
    pix = pts * 24.0 + 2.0  # margin so jittered strokes stay on canvas
    cols, rows = pix[:, 0], pix[:, 1]
    rr = np.arange(28, dtype=np.float64)
    dr2 = (rr[:, None] - rows[None, :]) ** 2  # [28, M]
    dc2 = (rr[:, None] - cols[None, :]) ** 2
    sigma = rng.uniform(0.75, 1.05)
    # max over stroke points of a Gaussian blob: constant-intensity strokes
    blob = np.exp(-(dr2[:, None, :] + dc2[None, :, :]) / (2.0 * sigma * sigma))
    return blob.max(axis=2)


def mnist_like(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(x [n, 784] float32 in [0, 1], y [n] int32) stroke-skeleton digits."""
    rng = np.random.default_rng((seed, 104729))
    y = rng.integers(0, 10, n).astype(np.int32)
    x = np.empty((n, 784), np.float32)
    skel = {d: np.concatenate(s, axis=0) for d, s in _STROKES.items()}
    for i in range(n):
        img = _render(skel[int(y[i])], rng)
        img *= rng.uniform(0.75, 1.0)
        img += rng.normal(0.0, 0.08, (28, 28))
        x[i] = np.clip(img, 0.0, 1.0).reshape(784).astype(np.float32)
    return x, y


def train_test(n_train: int, n_test: int, seed: int = 0):
    """((x_tr, y_tr), (x_te, y_te)) from disjoint deterministic streams."""
    return mnist_like(n_train, seed=seed), mnist_like(n_test, seed=seed + 1)
