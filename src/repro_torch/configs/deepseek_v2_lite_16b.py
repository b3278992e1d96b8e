"""deepseek-v2-lite-16b: 27L d2048 16H d_ff=1408 V=102400, MLA kv_lora=512,
2 shared + 64 routed experts top-6. [arXiv:2405.04434; hf]
Interpretation: the assigned config lists 'MoE 64e top-6'; applied uniformly
to all layers (the HF release additionally makes layer 0 dense — noted)."""
from .base import ArchConfig, MLASpec, MoESpec

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    head_dim=128,
    mla=MLASpec(kv_lora=512, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoESpec(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    notes="MLA kv_lora=512, 2 shared + 64 routed top-6 [arXiv:2405.04434]",
)
