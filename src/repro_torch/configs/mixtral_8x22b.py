"""mixtral-8x22b: 56L d6144 48H (GQA kv=8) d_ff=16384 V=32768, 8 experts top-2,
sliding-window attention. [arXiv:2401.04088; hf]"""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
    head_dim=128, attn_window=4096,
    moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=16384),
    notes="8 experts top-2, sliding-window attention [arXiv:2401.04088]",
)
