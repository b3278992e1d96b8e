"""whisper-small: 12 enc + 12 dec layers d768 12H d_ff=3072 V=51865; enc-dec
with the conv frontend stubbed (input_specs provides frame embeddings).
[arXiv:2212.04356] Interpretation: assigned '12L' = 12 encoder + 12 decoder."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, pos="learned", norm="ln", max_decoder_len=448,
    notes="enc-dec; conv frontend stub provides frame embeddings [arXiv:2212.04356]",
)
