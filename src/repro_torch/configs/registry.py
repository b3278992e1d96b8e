"""Registry of the architectures this package serves, selectable via
``--arch <id>``.  The dense family (olmo-1b) is the first one carried over."""
from __future__ import annotations

from . import olmo_1b
from .base import ArchConfig

__all__ = ["ARCHS", "get_arch"]

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in (olmo_1b,)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
