"""CUDA kernels for the paper's compute hot spots, written for Hopper.

Each kernel module holds the wrapper (CUDA tensor -> kernel, CPU tensor ->
plain version), the plain PyTorch version, and names its CUDA source under
``csrc/``.  Nothing is compiled at import: ``build.load()`` runs ``nvcc`` at
the first launch.
"""
from .group_prox import group_prox, group_prox_plain  # noqa: F401
from .lcc_chain_matmul import lcc_chain_matmul, lcc_chain_matmul_plain  # noqa: F401
from .lcc_group_matmul import lcc_group_matmul, lcc_group_matmul_plain  # noqa: F401
from .shared_matmul import (cluster_segment_sum,  # noqa: F401
                            cluster_segment_sum_plain, csr_from_labels)
