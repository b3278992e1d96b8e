"""Per-family compressible sites (counterpart of
``repro.models.compress_adapters``).

Every family names its compressible matrices once: ``sites(params, cfg)``
lists :class:`DenseSite` records — where each matrix lives in the params
tree, its leading stacked indices (layer, expert) and how it is stored (the
``dense_init`` [K, N] layout vs the paper's [N, K] ``y = W x`` layout).
Training derives its group-lasso layouts from these records
(``training.regularize``), so the groups the prox zeroes are the ones the
compressor slices; the compressor reads each site's matrix as a float64
numpy array (:meth:`DenseSite.weight`) and :func:`rebind_site` writes a
dense-effective map back into a new params tree of tensors
(:func:`rebind_site_traced` does the same with a tensor that carries
autograd, for recovery fine-tuning).  Site names,
paths, indices and ``transpose`` flags are the reference's, so artifact keys
cross between the packages.

Families with a table here: dense and vlm (olmo-1b and relatives), moe
(mixtral-8x22b, and deepseek-v2-lite with its MLA projections and shared
experts), ssm (rwkv6's time-mix r/k/v/g/o and channel-mix k/v/r), hybrid
(zamba2's mamba in/out projections a layer and the weight-shared block's
sites, unstacked and without a layer index), mlp (the paper's MLP) and
resnet (every conv kernel as a :class:`ConvSite` — the stem, each block's
conv1/conv2 and its 1x1 ``proj`` — and the linear head) and audio
(whisper's encoder layers' MLP and attention, then the decoder layers' MLP,
self-attention and cross-attention, every q/k/v/o).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.compress import CompressibleConv, CompressibleDense

__all__ = ["DenseSite", "ConvSite", "sites_for", "units_from_sites",
           "rebind_site", "rebind_site_traced", "effective_conv_kernel",
           "register_family", "FAMILY_SITE_FNS"]


def _to_f64(a) -> np.ndarray:
    """A tensor (any float dtype, any device) or array as float64 numpy.  A
    bf16 or f16 tensor goes through float32, exactly, as numpy has no bf16."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu")
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.to(torch.float32)
        a = t.numpy()
    return np.asarray(a, np.float64)


@dataclass(frozen=True)
class DenseSite:
    """One dense matrix: ``params[path...][index...]`` viewed as y = W x."""

    name: str
    path: tuple  # keys into the params tree down to the array
    index: tuple = ()  # leading indices into stacked axes (layer, expert, ...)
    transpose: bool = True  # True: stored [K, N] (dense_init layout)

    def weight(self, params) -> np.ndarray:
        a = _lookup(params, self.path)
        for i in self.index:
            a = a[i]
        w = _to_f64(a)
        return w.T if self.transpose else w


@dataclass(frozen=True)
class ConvSite:
    """One conv kernel [N, K, O, O] (NCHW/OIHW models)."""

    name: str
    path: tuple
    index: tuple = ()

    def kernel(self, params) -> np.ndarray:
        a = _lookup(params, self.path)
        for i in self.index:
            a = a[i]
        return _to_f64(a)


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_in(tree, path, value):
    """Functional nested update; dict levels are copied, list levels rebuilt."""
    if not path:
        return value
    k, rest = path[0], path[1:]
    if isinstance(tree, list):
        out = list(tree)
        out[k] = _set_in(tree[k], rest, value)
        return out
    out = dict(tree)
    out[k] = _set_in(tree[k], rest, value)
    return out


def _leaf_like(new: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``new`` as a tensor of ``like``'s dtype on its device.  A float64
    array reaches a 16-bit dtype through float32, as the reference's
    ``jnp.asarray(new, dtype)`` does."""
    t = torch.from_numpy(np.ascontiguousarray(new))
    if like.dtype in (torch.bfloat16, torch.float16):
        t = t.to(torch.float32)
    return t.to(dtype=like.dtype).to(like.device)


def rebind_site(params, site: DenseSite | ConvSite, effective: np.ndarray):
    """Write a dense-effective weight (or conv kernel) back at ``site``.

    ``effective`` is [N, K_orig] for dense sites (pruned columns already
    zero-expanded) and [N, K, O, O] for conv sites.  Returns a new params
    tree whose leaf at ``site`` is a new tensor of the old leaf's dtype and
    device; the original tree and its tensors are untouched.
    """
    arr = _lookup(params, site.path)
    new = np.asarray(effective)
    if isinstance(site, DenseSite) and site.transpose:
        new = new.T
    leaf = _leaf_like(new, arr)
    if site.index:
        out = arr.detach().clone()
        out[site.index] = leaf
        leaf = out
    return _set_in(params, site.path, leaf)


def rebind_site_traced(params, site: DenseSite | ConvSite,
                       effective: torch.Tensor):
    """:func:`rebind_site` for a tensor ``effective`` that may require
    grad: no host round trip, so recovery fine-tuning can build its loss
    through the rebind and differentiate with respect to the compressed
    parameterization.  The leaf is ``effective`` (transposed for a
    ``[K, N]`` site) cast to the old leaf's dtype; at an indexed site it is
    written into a clone of the stacked leaf, so the gradient reaches
    ``effective`` through the write."""
    arr = _lookup(params, site.path)
    new = effective
    if isinstance(site, DenseSite) and site.transpose:
        new = new.transpose(-1, -2)
    leaf = new.to(arr.dtype)
    if site.index:
        out = arr.clone()
        out[site.index] = leaf
        leaf = out
    return _set_in(params, site.path, leaf)


def units_from_sites(params, sites) -> list[CompressibleDense | CompressibleConv]:
    out: list[CompressibleDense | CompressibleConv] = []
    for s in sites:
        if isinstance(s, DenseSite):
            out.append(CompressibleDense(name=s.name, weight=s.weight(params)))
        else:
            out.append(CompressibleConv(name=s.name, kernel=s.kernel(params)))
    return out


def effective_conv_kernel(kernel: np.ndarray, conv_record: dict,
                          method: str = "pk") -> np.ndarray:
    """Dense-equivalent kernel of a ``compress_conv_kernel`` record.

    Channels with a decomposition are replaced by the decomposition's dense
    equivalent (inverting the FK/PK reshape); subsampled or pruned-out
    channels keep their original values — the accounting already covers them.
    """
    n, k, oh, ow = kernel.shape
    eff = np.array(kernel, np.float64, copy=True)
    for ch, dec in conv_record["decompositions"].items():
        m = dec.to_dense()
        if method == "fk":
            eff[:, ch] = m.reshape(n, oh, ow)
        else:  # pk rows are (n, j): kernel columns of length oh
            eff[:, ch] = m.reshape(n, ow, oh).transpose(0, 2, 1)
    return eff


# ---------------------------------------------------------------------------
# per-family site enumerations
# ---------------------------------------------------------------------------


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


def _ssm_sites(params, cfg) -> list[DenseSite]:
    sites: list[DenseSite] = []
    for li in range(cfg.n_layers):
        for p in ("r", "k", "v", "g", "o"):
            sites.append(DenseSite(name=f"tm.{p}.l{li}",
                                   path=("blocks", "tm", p, "w"), index=(li,)))
        for p in ("k", "v", "r"):
            sites.append(DenseSite(name=f"cm.{p}.l{li}",
                                   path=("blocks", "cm", p, "w"), index=(li,)))
    return sites


def _hybrid_sites(params, cfg) -> list[DenseSite]:
    sites: list[DenseSite] = []
    for li in range(cfg.n_layers):
        for p in ("in_proj", "out_proj"):
            sites.append(DenseSite(name=f"mamba.{p}.l{li}",
                                   path=("blocks", "mamba", p, "w"), index=(li,)))
    # the one weight-shared attention+MLP block (unstacked)
    sites += _ffn_sites((), tag="shared_attn.ffn", base=("shared_attn", "ffn"))
    sites += _attn_sites(cfg, ("shared_attn", "attn"), (), "shared_attn.attn")
    return sites


def _audio_sites(params, cfg) -> list[DenseSite]:
    sites: list[DenseSite] = []
    for li in range(cfg.enc_layers):
        sites += _ffn_sites((li,), tag="enc.mlp", projs=("fc1", "fc2"),
                            base=("enc_blocks", "mlp"))
        sites += _attn_sites(cfg, ("enc_blocks", "attn"), (li,), "enc.attn")
    for li in range(cfg.n_layers):
        sites += _ffn_sites((li,), tag="dec.mlp", projs=("fc1", "fc2"),
                            base=("dec_blocks", "mlp"))
        sites += _attn_sites(cfg, ("dec_blocks", "attn"), (li,), "dec.attn")
        sites += _attn_sites(cfg, ("dec_blocks", "xattn"), (li,), "dec.xattn")
    return sites


def _mlp_sites(params, cfg) -> list[DenseSite]:
    # weights are stored [N, K] acting as y = W x (the paper layout): no
    # transpose.  fc1 is the paper's compression target (Sec. IV-A); fc2 is
    # listed too and filtered via ``include=`` when only fc1 is wanted.
    return [DenseSite(name="fc1", path=("fc1", "w"), transpose=False),
            DenseSite(name="fc2", path=("fc2", "w"), transpose=False)]


def _resnet_sites(params, cfg) -> list[DenseSite | ConvSite]:
    sites: list[DenseSite | ConvSite] = [ConvSite(name="stem", path=("stem",))]
    for i, blk in enumerate(params["blocks"]):
        sites.append(ConvSite(name=f"block{i}.conv1", path=("blocks", i, "conv1")))
        sites.append(ConvSite(name=f"block{i}.conv2", path=("blocks", i, "conv2")))
        if "proj" in blk:
            sites.append(ConvSite(name=f"block{i}.proj", path=("blocks", i, "proj")))
    sites.append(DenseSite(name="head", path=("head", "w"), transpose=False))
    return sites


FAMILY_SITE_FNS = {
    "dense": _dense_sites,
    "vlm": _dense_sites,
    "moe": _moe_sites,
    "mlp": _mlp_sites,
    "ssm": _ssm_sites,
    "hybrid": _hybrid_sites,
    "audio": _audio_sites,
    "resnet": _resnet_sites,
}


def sites_for(params, cfg) -> list[DenseSite | ConvSite]:
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
