"""Exchange formats of the compression pipeline: LCC containers, compressed
dense records, weight-sharing layers and the in-memory model artifact."""
from .artifact import CompressedModel  # noqa: F401
from .compress import CompressedDense, CompressionConfig  # noqa: F401
from .lcc import (FSProgram, LCCChain, LCCDecomposition, LCCFactor,  # noqa: F401
                  plan_col_slices)
from .weight_sharing import SharedLayer  # noqa: F401
