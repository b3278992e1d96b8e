"""Per-family compressible sites (counterpart of
``repro.models.compress_adapters``).

Every family names its compressible matrices once: ``sites(params, cfg)``
lists :class:`DenseSite` records — where each matrix lives in the params
tree, its leading stacked indices (layer, expert) and how it is stored (the
``dense_init`` [K, N] layout vs the paper's [N, K] ``y = W x`` layout).
Training derives its group-lasso layouts from these records
(``training.regularize``), so the groups the prox zeroes are the ones the
compressor slices.  Site names, paths, indices and ``transpose`` flags are
the reference's, so artifact keys cross between the packages.

Families with a table here: dense (olmo-1b), moe (mixtral-8x22b, and
deepseek-v2-lite with its MLA projections and shared experts) and mlp (the
paper's MLP).  The others raise ``NotImplementedError`` naming where they
stand in the roadmap.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["DenseSite", "sites_for", "register_family", "FAMILY_SITE_FNS"]


@dataclass(frozen=True)
class DenseSite:
    """One dense matrix: ``params[path...][index...]`` viewed as y = W x."""

    name: str
    path: tuple  # keys into the params tree down to the array
    index: tuple = ()  # leading indices into stacked axes (layer, expert, ...)
    transpose: bool = True  # True: stored [K, N] (dense_init layout)


def _attn_sites(cfg, base_path, layer_index, tag) -> list[DenseSite]:
    projs = ("q", "dkv", "kr", "uk", "uv", "o") if cfg.mla is not None \
        else ("q", "k", "v", "o")
    return [DenseSite(name=f"{tag}.{p}.l{layer_index[-1]}" if layer_index
                      else f"{tag}.{p}",
                      path=base_path + (p, "w"), index=layer_index)
            for p in projs]


def _ffn_sites(layer_index, tag="ffn", projs=("gate", "up", "down"),
               base=("blocks", "ffn")) -> list[DenseSite]:
    li = layer_index[-1] if layer_index else None
    return [DenseSite(name=f"{tag}.{p}.l{li}" if layer_index else f"{tag}.{p}",
                      path=base + (p, "w"), index=layer_index)
            for p in projs]


def _dense_sites(params, cfg) -> list[DenseSite]:
    sites: list[DenseSite] = []
    for li in range(cfg.n_layers):
        sites += _ffn_sites((li,))
        sites += _attn_sites(cfg, ("blocks", "attn"), (li,), "attn")
    return sites


def _moe_sites(params, cfg) -> list[DenseSite]:
    sites: list[DenseSite] = []
    ffn = params["blocks"]["ffn"]
    for li in range(cfg.n_layers):
        for p in ("gate", "up", "down"):
            for e in range(cfg.moe.n_experts):
                # expert stacks are raw [L, E, in, out] arrays (no "w" level)
                sites.append(DenseSite(name=f"moe.{p}.l{li}.e{e}",
                                       path=("blocks", "ffn", p),
                                       index=(li, e)))
        if "shared" in ffn:
            sites += _ffn_sites((li,), tag="moe.shared",
                                base=("blocks", "ffn", "shared"))
        sites += _attn_sites(cfg, ("blocks", "attn"), (li,), "attn")
    return sites


def _mlp_sites(params, cfg) -> list[DenseSite]:
    # weights are stored [N, K] acting as y = W x (the paper layout): no
    # transpose.  fc1 is the paper's compression target (Sec. IV-A); fc2 is
    # listed too and filtered via ``include=`` when only fc1 is wanted.
    return [DenseSite(name="fc1", path=("fc1", "w"), transpose=False),
            DenseSite(name="fc2", path=("fc2", "w"), transpose=False)]


def _not_ported(family: str, where: str):
    def fn(params, cfg):
        raise NotImplementedError(
            f"family {family!r} has no site table in this package yet ({where})")
    return fn


_LATER = "the remaining families, ROADMAP Queue A"
FAMILY_SITE_FNS = {
    "dense": _dense_sites,
    "moe": _moe_sites,
    "mlp": _mlp_sites,
    "vlm": _not_ported("vlm", _LATER + " (qwen2-vl m-RoPE)"),
    "ssm": _not_ported("ssm", _LATER),
    "hybrid": _not_ported("hybrid", _LATER),
    "audio": _not_ported("audio", _LATER),
    "resnet": _not_ported("resnet", _LATER + " (ResNet + ConvLCC)"),
}


def sites_for(params, cfg) -> list[DenseSite]:
    """All compressible sites of (params, cfg), from the family registry."""
    from .api import family_of

    family = family_of(cfg)
    try:
        fn = FAMILY_SITE_FNS[family]
    except KeyError:
        raise KeyError(
            f"no compression adapter registered for family {family!r}; "
            f"known: {sorted(FAMILY_SITE_FNS)}") from None
    return fn(params, cfg)


def register_family(family: str, site_fn) -> None:
    """Extension hook: plug a new architecture family into the registry."""
    FAMILY_SITE_FNS[family] = site_fn
