"""Addition accounting and compression ratios (paper Sec. IV).

Compression ratio = adds(uncompressed model, CSD) / adds(compressed model).
Only matrix-vector-product additions are counted (activations etc. excluded),
exactly as in the paper.  Weight *bytes* moved per matvec are tracked too
(the quantity that bounds memory-bound decode).  Numpy, as the reference's
``repro.core.cost``, so reports agree number for number.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .csd import adds_csd_matrix
from .lcc import LCCDecomposition
from .weight_sharing import SharedLayer

__all__ = ["LayerCost", "ModelCostReport", "dense_layer_adds", "pruned_layer_adds",
           "shared_layer_adds", "lcc_layer_adds", "dense_bytes"]


def dense_layer_adds(w: np.ndarray, frac_bits: int = 8) -> int:
    """CSD shift-add cost of the uncompressed (but quantized) matrix."""
    return adds_csd_matrix(w, frac_bits)


def pruned_layer_adds(w: np.ndarray, frac_bits: int = 8) -> int:
    """After structured pruning: zero rows/cols simply drop out of the CSD count."""
    return adds_csd_matrix(w, frac_bits)


def shared_layer_adds(layer: SharedLayer, frac_bits: int = 8) -> int:
    """Eq. (10): input pre-aggregation adds + CSD adds of the centroid matrix."""
    return layer.pre_aggregation_adds() + adds_csd_matrix(layer.centroids, frac_bits)


def lcc_layer_adds(dec: LCCDecomposition, pre_aggregation: int = 0) -> int:
    return pre_aggregation + dec.num_adds()


def dense_bytes(w: np.ndarray, bytes_per_weight: float = 2.0) -> int:
    """HBM bytes to stream the dense weights once (bf16 by default)."""
    return int(w.shape[0] * w.shape[1] * bytes_per_weight)


@dataclass
class LayerCost:
    name: str
    baseline_adds: int
    stage_adds: dict[str, int] = field(default_factory=dict)  # stage -> adds
    stage_bytes: dict[str, int] = field(default_factory=dict)
    extra: dict = field(default_factory=dict)

    def ratio(self, stage: str) -> float:
        a = self.stage_adds.get(stage, 0)
        return self.baseline_adds / a if a > 0 else float("inf")


@dataclass
class ModelCostReport:
    layers: list[LayerCost] = field(default_factory=list)

    def add(self, layer: LayerCost) -> None:
        self.layers.append(layer)

    def total_baseline(self) -> int:
        return sum(l.baseline_adds for l in self.layers)

    def total_stage(self, stage: str) -> int:
        return sum(l.stage_adds.get(stage, l.baseline_adds) for l in self.layers)

    def ratio(self, stage: str) -> float:
        s = self.total_stage(stage)
        return self.total_baseline() / s if s > 0 else float("inf")

    def table(self) -> str:
        stages: list[str] = []
        for l in self.layers:
            for s in l.stage_adds:
                if s not in stages:
                    stages.append(s)
        hdr = "layer,baseline_adds," + ",".join(f"{s}_adds,{s}_ratio" for s in stages)
        rows = [hdr]
        for l in self.layers:
            cells = [l.name, str(l.baseline_adds)]
            for s in stages:
                a = l.stage_adds.get(s)
                cells += [str(a) if a is not None else "",
                          f"{l.ratio(s):.2f}" if a else ""]
            rows.append(",".join(cells))
        tot = ["TOTAL", str(self.total_baseline())]
        for s in stages:
            tot += [str(self.total_stage(s)), f"{self.ratio(s):.2f}"]
        rows.append(",".join(tot))
        return "\n".join(rows)
