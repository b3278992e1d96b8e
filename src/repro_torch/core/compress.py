"""Records of Algorithm 1's output: the compression knobs and one compressed
dense layer.  The procedure that produces them is not part of this package
yet; records arrive from the JAX package (``repro_torch.convert``) or from
the seeded fixture (``repro_torch.testing``)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .lcc import LCCDecomposition
from .weight_sharing import SharedLayer

__all__ = ["CompressionConfig", "CompressedDense"]


@dataclass
class CompressionConfig:
    algorithm: str = "fs"  # 'fp' | 'fs'
    s_terms: int = 2
    frac_bits: int = 8
    target_snr_db: float | None = None  # None => match CSD quantization SNR
    snr_offset_db: float = 0.0
    slice_width: int | None = None
    weight_sharing: bool = True
    share_damping: float = 0.7
    share_preference: float | None = None
    share_clusters: int | None = None
    conv_method: str = "pk"  # 'fk' | 'pk'
    prune_tol: float = 1e-8
    max_share_rel_err: float | None = None
    max_factors: int = 24
    max_terms_per_row: int = 64


@dataclass
class CompressedDense:
    """Everything needed to run + account one compressed dense layer."""

    name: str
    kept_columns: np.ndarray  # indices into the original K inputs
    shared: SharedLayer | None  # None if weight sharing disabled
    decomposition: LCCDecomposition
    # dense equivalent of the compressed map [N, K_kept]; None where the
    # artifact keeps no host copy (the seeded fixture at full MoE width)
    effective: np.ndarray | None

    def apply(self, x: np.ndarray) -> np.ndarray:
        """Reference evaluation: x [K_orig, ...] -> y [N, ...]."""
        xk = x[self.kept_columns]
        if self.shared is not None:
            c = self.shared.n_clusters
            agg = np.zeros((c,) + xk.shape[1:])
            np.add.at(agg, self.shared.labels, xk)
            return self.decomposition.apply(agg)
        return self.decomposition.apply(xk)
