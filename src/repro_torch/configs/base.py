"""Architecture configuration schema (counterpart of ``repro.configs.base``).

One ``ArchConfig`` per architecture with the exact published numbers.  The
field set and ``arch_to_dict``/``arch_from_dict`` are kept identical to the
JAX package so a config crosses between the two as a plain dict; dtype names
resolve to ``torch.dtype``.  The shape-cell dry-run helpers are not part of
this package.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, replace

import torch

__all__ = ["MoESpec", "MLASpec", "SSMSpec", "ArchConfig", "reduced_config",
           "arch_to_dict", "arch_from_dict", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True


@dataclass(frozen=True)
class MLASpec:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMSpec:
    d_inner: int
    d_state: int
    head_dim: int = 64
    d_conv: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    norm: str = "rms"  # rms | nonparam | ln
    pos: str = "rope"  # rope | mrope | learned | none
    rope_theta: float = 10000.0
    attn_window: int | None = None
    tie_embeddings: bool = False
    moe: MoESpec | None = None
    mla: MLASpec | None = None
    ssm: SSMSpec | None = None
    hybrid_period: int = 6
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    enc_layers: int = 0
    max_decoder_len: int = 448
    inputs: str = "tokens"
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    q_chunk: int = 1024
    ssm_chunk: int = 256
    remat: bool = True
    causal_chunk_skip: bool = False
    moe_manual: bool = False
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)


def arch_to_dict(cfg: ArchConfig) -> dict:
    """JSON-serializable form of an ArchConfig (inverse: ``arch_from_dict``)."""
    d = asdict(cfg)
    d["mrope_sections"] = list(d["mrope_sections"])
    return d


def arch_from_dict(d: dict) -> ArchConfig:
    d = dict(d)
    if d.get("moe") is not None:
        d["moe"] = MoESpec(**d["moe"])
    if d.get("mla") is not None:
        d["mla"] = MLASpec(**d["mla"])
    if d.get("ssm") is not None:
        d["ssm"] = SSMSpec(**d["ssm"])
    d["mrope_sections"] = tuple(d["mrope_sections"])
    return ArchConfig(**d)


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU tests (same rule as the JAX package)."""
    small = dict(
        n_layers=min(cfg.n_layers, 2 * max(1, cfg.hybrid_period // 3)) if cfg.family == "hybrid"
        else min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        q_chunk=64,
        ssm_chunk=32,
        enc_layers=2 if cfg.enc_layers > 0 else 0,
        max_decoder_len=32,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        small["moe"] = MoESpec(n_experts=4, top_k=2, d_ff_expert=64,
                               n_shared=min(cfg.moe.n_shared, 1),
                               capacity_factor=8.0)
    if cfg.mla is not None:
        small["mla"] = MLASpec(kv_lora=32, qk_nope=32, qk_rope=16, v_dim=32)
    if cfg.ssm is not None:
        small["ssm"] = SSMSpec(d_inner=256, d_state=16, head_dim=32, d_conv=4)
    if cfg.family == "hybrid":
        small["hybrid_period"] = 2
        small["n_layers"] = 4
    if cfg.pos == "mrope":
        half = small.get("head_dim", cfg.hd) // 2
        t = max(1, half // 4)
        small["mrope_sections"] = (t, (half - t) // 2, half - t - (half - t) // 2)
    small.update(overrides)
    return replace(cfg, **small)
