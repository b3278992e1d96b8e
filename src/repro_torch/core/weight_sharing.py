"""Weight sharing via affinity-propagation column clustering (paper Sec. III-C).

Pipeline (method of Zhang et al. [29], as adopted by the paper):
 1. cluster the *columns* of a trained weight matrix with affinity propagation
    (implemented from scratch -- no scikit-learn in this environment; same
    message-passing updates as Frey & Dueck 2007);
 2. retrain with tied parameters: the centroid gradient is the *mean* of its
    members' gradients (eq. (9));
 3. evaluate with eq. (10):  W x = sum_i g_i * (sum_{j in I_i} x_j)
    -- a per-cluster input pre-aggregation (scalar adds only) followed by a
    small dense matrix of unique centroids.

The clustering is numpy, the reference's (``repro.core.weight_sharing``)
operation for operation -- the tie-breaking jitter included, drawn from
``np.random.default_rng(seed)`` -- so both packages give bitwise the same
labels and centroids.  The three tensor helpers at the end take torch
tensors; their segment sums are ``index_add_`` over the labels in order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "affinity_propagation",
    "cluster_columns",
    "cluster_columns_fixed",
    "SharedLayer",
    "shared_matvec",
    "centroid_grad_from_member_grads",
    "expand_centroids",
]


def affinity_propagation(
    similarity: np.ndarray,
    damping: float = 0.7,
    max_iter: int = 300,
    convergence_iter: int = 20,
    preference: float | np.ndarray | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Affinity propagation (Frey & Dueck, Science 2007). Returns labels [n].

    ``similarity[i,k]``: suitability of k as exemplar for i. ``preference``
    (diagonal) controls cluster count; defaults to the median similarity, the
    standard choice (also sklearn's default).
    """
    s = np.array(similarity, dtype=np.float64, copy=True)
    n = s.shape[0]
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    if preference is None:
        preference = np.median(s[~np.eye(n, dtype=bool)])
    s[np.diag_indices(n)] = preference
    # tiny noise breaks degenerate ties (as in the reference implementation)
    rng = np.random.default_rng(seed)
    s += 1e-12 * rng.standard_normal((n, n)) * (np.max(s) - np.min(s) + 1e-30)

    r = np.zeros((n, n))
    a = np.zeros((n, n))
    idx = np.arange(n)
    stable = 0
    last_ex: np.ndarray | None = None
    for _ in range(max_iter):
        # responsibilities
        as_ = a + s
        first = np.max(as_, axis=1)
        jmax = np.argmax(as_, axis=1)
        as_[idx, jmax] = -np.inf
        second = np.max(as_, axis=1)
        rnew = s - first[:, None]
        rnew[idx, jmax] = s[idx, jmax] - second
        r = damping * r + (1 - damping) * rnew
        # availabilities
        rp = np.maximum(r, 0.0)
        rp[np.diag_indices(n)] = r[np.diag_indices(n)]
        col = rp.sum(axis=0)
        anew = col[None, :] - rp
        dA = np.diag(anew).copy()
        anew = np.minimum(anew, 0.0)
        anew[np.diag_indices(n)] = dA
        a = damping * a + (1 - damping) * anew
        # convergence: exemplar set unchanged for ``convergence_iter`` rounds
        ex = np.where(np.diag(a + r) > 0)[0]
        if last_ex is not None and ex.size == last_ex.size and np.array_equal(ex, last_ex):
            stable += 1
            if stable >= convergence_iter and ex.size > 0:
                break
        else:
            stable = 0
        last_ex = ex

    exemplars = np.where(np.diag(a + r) > 0)[0]
    if exemplars.size == 0:
        exemplars = np.array([int(np.argmax(np.diag(a + r)))])
    # assign each point to its best exemplar; exemplars point to themselves
    labels_ex = np.argmax(s[:, exemplars], axis=1)
    labels_ex[exemplars] = np.arange(exemplars.size)
    return labels_ex.astype(np.int64)


def cluster_columns(
    w: np.ndarray,
    damping: float = 0.7,
    max_iter: int = 300,
    preference: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Cluster the columns of ``w`` -> (labels [K], centroids [N, C]).

    Similarity = negative squared euclidean distance between columns
    (the standard affinity for AP). Centroids are cluster means.
    """
    w = np.asarray(w, dtype=np.float64)
    cols = w.T  # [K, N]
    d2 = np.sum(cols**2, axis=1, keepdims=True)
    sim = -(d2 + d2.T - 2.0 * cols @ cols.T)
    labels = affinity_propagation(sim, damping=damping, max_iter=max_iter, preference=preference)
    c = int(labels.max()) + 1
    centroids = np.zeros((w.shape[0], c))
    for i in range(c):
        centroids[:, i] = w[:, labels == i].mean(axis=1)
    return labels, centroids


def cluster_columns_fixed(
    w: np.ndarray,
    n_clusters: int,
    n_iter: int = 5,
) -> tuple[np.ndarray, np.ndarray]:
    """Cluster columns into (at most) an *exact requested count* of clusters.

    Affinity propagation picks its own cluster count; the adds-budget
    allocator needs the count as a continuous dial between "a handful of
    centroids" and "no sharing at all" (``n_clusters >= K``).  Deterministic:
    farthest-point (k-center) seeding from the max-norm column + a few Lloyd
    refinements, no RNG — so pipeline re-runs and resumed runs are bitwise
    reproducible.  Returns (labels [K], centroids [N, C]); C can come out
    below ``n_clusters`` when columns coincide or clusters empty out.
    """
    w = np.asarray(w, dtype=np.float64)
    cols = w.T  # [K, N]
    k = cols.shape[0]
    c = max(1, min(int(n_clusters), k))
    chosen = [int(np.argmax(np.sum(cols**2, axis=1)))]
    d2 = np.sum((cols - cols[chosen[0]]) ** 2, axis=1)
    while len(chosen) < c:
        j = int(np.argmax(d2))
        if d2[j] <= 0.0:
            break  # duplicate columns: fewer distinct centers exist
        chosen.append(j)
        d2 = np.minimum(d2, np.sum((cols - cols[j]) ** 2, axis=1))
    cents = cols[chosen].copy()  # [C, N]

    def assign(cents):
        # ||a-b||^2 via the matmul identity: [K, C] memory, never [K, C, N]
        # (C can be ~K when the allocator dials toward the unshared end)
        d = (np.sum(cols**2, axis=1)[:, None]
             + np.sum(cents**2, axis=1)[None, :] - 2.0 * cols @ cents.T)
        return np.argmin(d, axis=1)

    for _ in range(n_iter):
        labels = assign(cents)
        for i in range(cents.shape[0]):
            m = labels == i
            if m.any():
                cents[i] = cols[m].mean(axis=0)
    labels = assign(cents)
    used = np.unique(labels)  # drop empty clusters, relabel compactly
    remap = np.zeros(cents.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    return remap[labels].astype(np.int64), cents[used].T.copy()


@dataclass
class SharedLayer:
    """Weight-shared layer: W == centroids[:, labels] (eq. (10) evaluation)."""

    centroids: np.ndarray  # [N, C]
    labels: np.ndarray  # [K] int, cluster id per input column

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[1]

    def expand(self) -> np.ndarray:
        return self.centroids[:, self.labels]

    def pre_aggregation_adds(self) -> int:
        """Scalar adds for the per-cluster input sums: sum_i (|I_i| - 1)."""
        counts = np.bincount(self.labels, minlength=self.n_clusters)
        return int(np.maximum(counts - 1, 0).sum())


def _labels(labels, device) -> torch.Tensor:
    """Cluster ids as an int64 tensor on ``device`` (numpy labels may be
    stored as uint16, which torch does not index with)."""
    if isinstance(labels, torch.Tensor):
        return labels.to(device=device, dtype=torch.long)
    return torch.from_numpy(np.array(labels, np.int64)).to(device)


def _segment_sum(x: torch.Tensor, labels, n_segments: int) -> torch.Tensor:
    """Rows of ``x`` [K, ...] summed by ``labels`` [K] -> [n_segments, ...]."""
    labels = _labels(labels, x.device)
    out = torch.zeros((n_segments,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, labels, x)


def shared_matvec(centroids: torch.Tensor, labels, x: torch.Tensor) -> torch.Tensor:
    """Eq. (10):  y = G @ segment_sum(x, labels).  x: [..., K] -> [..., N]."""
    c = centroids.shape[1]
    x_agg = _segment_sum(torch.movedim(x, -1, 0), labels, c)  # [C, ...]
    dt = torch.promote_types(centroids.dtype, x_agg.dtype)
    y = torch.tensordot(centroids.to(dt), x_agg.to(dt), dims=([1], [0]))  # [N, ...]
    return torch.movedim(y, 0, -1)


def expand_centroids(centroids: torch.Tensor, labels) -> torch.Tensor:
    """W = G[:, labels] — keeps autodiff flowing through tied params."""
    return torch.index_select(centroids, 1, _labels(labels, centroids.device))


def centroid_grad_from_member_grads(w_grad, labels, n_clusters: int) -> torch.Tensor:
    """Eq. (9): dL/dg_i = (1/|C_i|) * sum_{w in C_i} dL/dw  (columns of W)."""
    g = torch.as_tensor(w_grad)
    summed = _segment_sum(torch.movedim(g, -1, 0), labels, n_clusters)
    counts = _segment_sum(torch.ones((g.shape[-1],), dtype=g.dtype,
                                     device=g.device), labels, n_clusters)
    out = summed / torch.clamp(counts, min=1.0)[(...,) + (None,) * (summed.dim() - 1)]
    return torch.movedim(out, 0, -1)
