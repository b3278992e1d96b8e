"""Registry of the architectures this package serves, selectable via
``--arch <id>``: the dense family (olmo-1b) and the MoE family (mixtral-8x22b;
deepseek-v2-lite-16b with MLA attention and shared experts)."""
from __future__ import annotations

from . import deepseek_v2_lite_16b, mixtral_8x22b, olmo_1b
from .base import ArchConfig

__all__ = ["ARCHS", "get_arch"]

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                for m in (olmo_1b, mixtral_8x22b,
                                          deepseek_v2_lite_16b)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
