"""The paper's contribution — LCC, group-lasso pruning and weight sharing
(Algorithm 1, steps 2-3) — and its exchange formats: LCC containers,
compressed dense records, weight-sharing layers, the cost report and the
in-memory model artifact."""
from .artifact import CompressedModel  # noqa: F401
from .compress import (  # noqa: F401
    CompressedDense,
    CompressibleConv,
    CompressibleDense,
    CompressionConfig,
    compress_conv_kernel,
    compress_dense_matrix,
    compress_model_params,
)
from .cost import LayerCost, ModelCostReport  # noqa: F401
from .csd import adds_csd_matrix, csd_digit_count, csd_digits, quantize_fixed  # noqa: F401
from .lcc import (FSProgram, LCCChain, LCCDecomposition, LCCFactor,  # noqa: F401
                  lcc_decompose, plan_col_slices, snr_db)
from .weight_sharing import (  # noqa: F401
    SharedLayer,
    affinity_propagation,
    cluster_columns,
    shared_matvec,
)
