"""In-memory compressed-model artifact (offline compress once, serve many).

A :class:`CompressedModel` bundles what the serving engine needs: per-unit
:class:`CompressedDense` records (prune indices, weight-sharing labels and
centroids, the LCC decomposition), optional pre-packed kernel buffers,
dense-effective ``params`` (a drop-in nested dict of tensors for the plain
forward and for everything not compressed), the cost report, the configs
that produced it, the pipeline's run statistics, and the layer plans an
executor packed from it.  ``models.api.compress_model`` builds one.
Persistence (``save``/``load``) is not part of this package yet (ROADMAP
A1b), so plans live in memory only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .compress import CompressedDense, CompressionConfig

__all__ = ["CompressedModel"]


@dataclass
class CompressedModel:
    config: Any  # ArchConfig
    params: Any  # dense-effective nested dict of tensors
    records: dict[str, Any]  # unit name -> CompressedDense
    packed: dict[str, Any] = field(default_factory=dict)  # name -> PackedDecomposition
    report: Any = None  # ModelCostReport (None for a converted or seeded artifact)
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    unit_configs: dict[str, CompressionConfig] = field(default_factory=dict)
    pipeline_stats: dict = field(default_factory=dict)
    # layer plans: plan key ("step") -> {stage name -> PackedStage}; packed by
    # the executor on first use and reused by every later executor
    plans: dict[str, dict] = field(default_factory=dict)

    def unit_config_for(self, name: str) -> CompressionConfig:
        return self.unit_configs.get(name, self.compression)

    @property
    def family(self) -> str:
        return self.config.family

    def dense_unit_names(self) -> list[str]:
        return [n for n, r in self.records.items()
                if isinstance(r, CompressedDense)]
