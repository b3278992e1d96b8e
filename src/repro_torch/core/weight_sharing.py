"""Weight sharing — the layer container.  The clustering algorithms are not
part of this package yet."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SharedLayer"]


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
