"""zamba2-7b: 81 Mamba2 layers d3584, weight-shared attention block (32H,
d_ff=14336) inserted every 6 layers, ssm_state=64. [arXiv:2411.15242]"""
from .base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    head_dim=112, hybrid_period=6,
    ssm=SSMSpec(d_inner=7168, d_state=64, head_dim=64, d_conv=4),
    notes="Mamba2 backbone + weight-shared attention blocks [arXiv:2411.15242]",
)
