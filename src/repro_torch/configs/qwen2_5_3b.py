"""qwen2.5-3b: 36L d2048 16H (GQA kv=2) d_ff=11008 V=151936, QKV bias,
tied embeddings. [hf:Qwen/Qwen2.5]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936,
    qkv_bias=True, tie_embeddings=True,
    notes="GQA kv=2, QKV bias [hf:Qwen/Qwen2.5]",
)
