"""Single dispatch surface for the served families.

Launchers and the serving engine go through these functions so a new family
only has to plug in here.  Every function that allocates takes ``device=`` and
defaults to the GPU.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

from . import transformer

__all__ = ["init_params", "abstract_params", "train_loss", "prefill",
           "decode", "sample_tokens", "paged_supported", "paged_layout",
           "init_decode_state", "family_of"]


def init_params(seed: int, cfg: ArchConfig, device="cuda"):
    return transformer.init_params(seed, cfg, device)


def abstract_params(cfg: ArchConfig):
    """Shapes and dtypes of the parameters as ``meta`` tensors — nothing
    allocated (what ``site_group_specs`` needs before a model exists)."""
    return transformer.abstract_params(cfg)


def train_loss(params, cfg: ArchConfig, batch):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``)."""
    return transformer.loss_fn(params, cfg, batch)


def family_of(cfg) -> str:
    """Adapter-registry key of a config object (``ArchConfig`` or
    ``MLPConfig``)."""
    fam = getattr(cfg, "family", None)
    if fam is None:
        raise TypeError(
            f"cannot infer architecture family from {type(cfg).__name__}")
    return fam


def prefill(params, cfg: ArchConfig, batch, *, collect_cache: bool = False):
    """Returns final hidden states (and caches when collect_cache)."""
    return transformer.forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        collect_cache=collect_cache)


def decode(params, cfg: ArchConfig, state, token, pos, *, executor=None):
    """One decode step; ``state`` is updated in place and returned.
    ``executor`` is the compressed-serving hook: a site-keyed registry
    (``repro_torch.serving.executor.CompressedExecutor``) that routes every
    covered projection through fused LCC kernel launches."""
    return transformer.decode_step(params, cfg, state, token, pos,
                                   executor=executor)


# splitmix64 constants, as signed 64-bit integers
_GOLDEN = -7046029254386353131  # 0x9E3779B97F4A7C15
_MIX1 = -4658895280553007687  # 0xBF58476D1CE4E5B9
_MIX2 = -7723592293110705685  # 0x94D049BB133111EB


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (``>>`` on a signed tensor is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """One splitmix64 output step on int64 (two's-complement wrap-around)."""
    z = x + _GOLDEN
    z = (z ^ _lsr(z, 30)) * _MIX1
    z = (z ^ _lsr(z, 27)) * _MIX2
    return z ^ _lsr(z, 31)


def sample_tokens(logits, keys, counts, temperature):
    """Device-side per-row sampling: logits [B, V], keys [B] int64 (one key
    per row, derived from the engine seed and the request id), counts [B]
    (tokens sampled so far), temperature [B].  Rows with temperature <= 0 take
    the argmax; the rest draw from ``softmax(logits / temperature)`` by the
    Gumbel-max rule, the noise coming from a counter-based generator keyed by
    (key, count, vocabulary index).  A row's draw therefore depends on nothing
    but its own key and count — not on batch composition, row order or which
    slot the request landed in — and needs no host round trip."""
    greedy = torch.argmax(logits, dim=-1)
    v = logits.shape[-1]
    row = _splitmix64(keys.long() ^ _splitmix64(counts.long()))
    bits = _splitmix64(row[:, None] + torch.arange(1, v + 1, device=logits.device))
    u = (_lsr(bits, 40).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    gumbel = -torch.log(-torch.log(u))
    t = temperature.to(torch.float32).clamp(min=1e-6)[:, None]
    sampled = torch.argmax(logits.to(torch.float32) / t + gumbel, dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy)


def request_key(seed: int, rid: int) -> int:
    """The sampling key of request ``rid`` under engine seed ``seed``."""
    mask = (1 << 64) - 1
    z = ((seed & mask) * 0x9E3779B97F4A7C15 + (rid & mask) + 1) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    z ^= z >> 31
    return z - (1 << 64) if z >= (1 << 63) else z


def paged_supported(cfg: ArchConfig) -> bool:
    """True when the family's decode cache can live in a paged block pool:
    pure-attention decoders."""
    return cfg.enc_layers == 0 and cfg.family not in ("ssm", "hybrid")


def paged_layout(cfg: ArchConfig, smax: int, kv_block: int,
                 kv_blocks: int | None = None, n_slots: int = 1):
    """(block_size, view_blocks, pool_entries) — see ``transformer.paged_layout``."""
    return transformer.paged_layout(cfg, smax, kv_block, kv_blocks, n_slots)


def init_decode_state(cfg: ArchConfig, batch: int, smax: int, *,
                      kv_block: int | None = None, kv_blocks: int | None = None,
                      device="cuda"):
    if not paged_supported(cfg):
        kv_block = kv_blocks = None
    return transformer.init_decode_state(cfg, batch, smax, kv_block=kv_block,
                                         kv_blocks=kv_blocks, device=device)
