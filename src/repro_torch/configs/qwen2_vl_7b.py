"""qwen2-vl-7b: 28L d3584 28H (GQA kv=4) d_ff=18944 V=152064, M-RoPE; vision
tower stubbed (input_specs provides patch/token embeddings). [arXiv:2409.12191]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064,
    qkv_bias=True, pos="mrope", mrope_sections=(16, 24, 24), inputs="embeds",
    notes="M-RoPE, dynamic resolution (stub) [arXiv:2409.12191]",
)
