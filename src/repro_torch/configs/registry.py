"""Registry of the architectures this package serves, selectable via
``--arch <id>``: the dense family (olmo-1b, qwen2.5-3b with QKV bias,
llama3.2-3b, yi-9b), the MoE family (mixtral-8x22b; deepseek-v2-lite-16b
with MLA attention and shared experts), the VLM family (qwen2-vl-7b:
m-RoPE, embeddings input, the vision tower stubbed), the ssm family
(rwkv6-1.6b), the hybrid family (zamba2-7b: Mamba2 layers and one
weight-shared attention block) and the audio family (whisper-small: an
encoder-decoder, the conv frontend stubbed) — the reference's ten archs."""
from __future__ import annotations

from . import (deepseek_v2_lite_16b, llama3_2_3b, mixtral_8x22b, olmo_1b,
               qwen2_5_3b, qwen2_vl_7b, rwkv6_1_6b, whisper_small, yi_9b,
               zamba2_7b)
from .base import ArchConfig

__all__ = ["ARCHS", "get_arch"]

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                for m in (olmo_1b, mixtral_8x22b,
                                          deepseek_v2_lite_16b, qwen2_5_3b,
                                          llama3_2_3b, yi_9b, qwen2_vl_7b,
                                          rwkv6_1_6b, zamba2_7b,
                                          whisper_small)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
