"""rwkv6-1.6b (Finch): 24L d2048 attention-free, d_ff=7168 V=65536,
data-dependent decay. [arXiv:2404.05892]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536,
    head_dim=64, pos="none",
    notes="Finch: data-dependent decay [arXiv:2404.05892]",
)
