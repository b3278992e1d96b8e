"""Single dispatch surface for the served families.

Launchers and the serving engine go through these functions so a new family
only has to plug in here.  Every function that allocates takes ``device=`` and
defaults to the GPU.

The same file is the dispatch surface for *compression*: the compressible-
unit adapter registry (:mod:`repro_torch.models.compress_adapters`) maps a
family to its dense matrices, and :func:`compress_model` runs Algorithm 1
over all of them, returning the
:class:`repro_torch.core.artifact.CompressedModel` that
``ServingEngine(artifact=...)`` serves.

``prefill``, ``prefill_extend`` and ``decode`` take ``mesh=`` (a serving
mesh): the call runs inside :class:`repro_torch.distributed.act_shard
.mesh_context`, and the models compute this rank's part of it from
:class:`~repro_torch.distributed.tp.Sharded` parameters.

``train_loss``, ``prefill``, ``prefill_extend`` and ``decode`` accept the
reference's ``unroll=`` keyword and ignore it: the reference unrolls its
``lax.scan`` over layers (and chunks) for its dry run's cost pass, while
these functions run eagerly, a Python loop over the layers, and have no
scan to unroll — the outputs are the same either way.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed.act_shard import mesh_context

from . import transformer, whisper

__all__ = ["init_params", "abstract_params", "train_loss", "prefill",
           "prefill_extend", "decode", "sample_tokens", "paged_supported", "paged_layout",
           "init_decode_state", "abstract_decode_state", "family_of", "register_compress_adapter",
           "compressible_units", "rebind", "compress_model"]


def init_params(seed: int, cfg: ArchConfig, device="cuda"):
    if cfg.enc_layers > 0:
        return whisper.init_params(seed, cfg, device)
    return transformer.init_params(seed, cfg, device)


def abstract_params(cfg: ArchConfig):
    """Shapes and dtypes of the parameters as ``meta`` tensors — nothing
    allocated (what ``site_group_specs`` needs before a model exists)."""
    if cfg.enc_layers > 0:
        return whisper.abstract_params(cfg)
    return transformer.abstract_params(cfg)


def train_loss(params, cfg: ArchConfig, batch, *, unroll: bool = False):
    """Mean next-token cross-entropy of ``batch`` (``tokens`` or
    ``embeds``, ``labels``; ``positions3`` for an m-RoPE model; ``frames``
    too for the encoder-decoder)."""
    if cfg.enc_layers > 0:
        return whisper.loss_fn(params, cfg, batch)
    return transformer.loss_fn(params, cfg, batch)


def family_of(cfg) -> str:
    """Adapter-registry key of a config object (``ArchConfig``,
    ``MLPConfig`` or ``ResNetConfig``, whose family is ``"resnet"``)."""
    fam = getattr(cfg, "family", None)
    if fam is not None:
        return fam
    from .resnet import ResNetConfig

    if isinstance(cfg, ResNetConfig):
        return "resnet"
    raise TypeError(f"cannot infer architecture family from {type(cfg).__name__}")


def _on(mesh):
    return contextlib.nullcontext() if mesh is None else mesh_context(mesh)


def prefill(params, cfg: ArchConfig, batch, *, unroll: bool = False,
            collect_cache: bool = False, mesh=None):
    """Returns final hidden states (and caches when collect_cache); the
    encoder-decoder returns its encoder's states of ``batch["frames"]`` and
    None (its decoder runs token by token against the cross-KV the caller
    fills)."""
    if cfg.enc_layers > 0:
        return whisper.encode(params, cfg, batch["frames"]), None
    with _on(mesh):
        return transformer.forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), positions3=batch.get("positions3"),
            collect_cache=collect_cache)


def prefill_extend(params, cfg: ArchConfig, tokens, positions, past, last, *,
                   unroll: bool = False, mesh=None):
    """Tail prefill against a resident KV prefix (prefix-cache hit path):
    see :func:`repro_torch.models.transformer.forward_extend`."""
    if not paged_supported(cfg):
        raise ValueError(f"prefill_extend: family {cfg.family!r} is not paged")
    with _on(mesh):
        return transformer.forward_extend(params, cfg, tokens, positions,
                                          past, last)


def decode(params, cfg: ArchConfig, state, token, pos, *, unroll: bool = False,
           executor=None, mesh=None):
    """One decode step; ``state`` is updated in place and returned.
    ``executor`` is the compressed-serving hook: a site-keyed registry
    (``repro_torch.serving.executor.CompressedExecutor``) that routes every
    covered projection through fused LCC kernel launches."""
    if cfg.enc_layers > 0:
        return whisper.decode_step(params, cfg, state, token, pos,
                                   executor=executor)
    with _on(mesh):
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
    pure-attention decoders.  The recurrent families' state is not a KV
    sequence and the encoder-decoder carries a cross cache: both keep the
    contiguous layout."""
    return cfg.enc_layers == 0 and cfg.family not in ("ssm", "hybrid")


def paged_layout(cfg: ArchConfig, smax: int, kv_block: int,
                 kv_blocks: int | None = None, n_slots: int = 1):
    """(block_size, view_blocks, pool_entries) — see ``transformer.paged_layout``."""
    return transformer.paged_layout(cfg, smax, kv_block, kv_blocks, n_slots)


def init_decode_state(cfg: ArchConfig, batch: int, smax: int, *,
                      kv_block: int | None = None, kv_blocks: int | None = None,
                      device="cuda"):
    """The decode state of ``batch`` slots over ``smax`` positions (paged
    with ``kv_block`` where :func:`paged_supported`); the encoder-decoder's
    cross-KV spans ``smax`` encoder positions."""
    if cfg.enc_layers > 0:
        return whisper.init_decode_state(cfg, batch, enc_len=smax,
                                         device=device)
    if not paged_supported(cfg):
        kv_block = kv_blocks = None
    return transformer.init_decode_state(cfg, batch, smax, kv_block=kv_block,
                                         kv_blocks=kv_blocks, device=device)


def abstract_decode_state(cfg: ArchConfig, cell: ShapeCell):
    """The contiguous decode state of ``cell``'s batch over its sequence as
    ``meta`` tensors — nothing allocated (decode_32k holds ~550 GB of
    olmo-1b KV cache)."""
    return init_decode_state(cfg, cell.global_batch, cell.seq_len,
                             device="meta")


# ---------------------------------------------------------------------------
# compression surface: family adapter registry + whole-model Algorithm 1
# ---------------------------------------------------------------------------


def register_compress_adapter(family: str, site_fn) -> None:
    """Register ``site_fn(params, cfg) -> list[DenseSite | ConvSite]`` for a
    family.  Built-in families are pre-registered by
    :mod:`repro_torch.models.compress_adapters`."""
    from . import compress_adapters

    compress_adapters.register_family(family, site_fn)


def compressible_units(params, cfg):
    """Every compressible unit (CompressibleDense / CompressibleConv) of the
    model, via the family's registered adapter."""
    from . import compress_adapters

    return compress_adapters.units_from_sites(
        params, compress_adapters.sites_for(params, cfg))


def rebind(params, cfg, name: str, effective):
    """Write a unit's dense-effective map back into a new params tree."""
    from . import compress_adapters

    for site in compress_adapters.sites_for(params, cfg):
        if site.name == name:
            return compress_adapters.rebind_site(params, site, effective)
    raise KeyError(f"no compressible unit named {name!r} for this model")


def compress_model(params, cfg, compression=None, *, include=None,
                   conv_channel_subsample=None, progress=None,
                   build_packed: bool = True, n_workers: int = 1,
                   budget_adds=None, cache_dir=None, run_dir=None,
                   resume: bool = False, metrics=None):
    """Steps 2-3 of Algorithm 1 over every compressible unit of a family,
    executed by the :mod:`repro_torch.pipeline` job graph (counterpart of
    ``repro.models.api.compress_model``, bitwise the same records).

    ``params`` is a nested dict of tensors (any float dtype, any device).
    Returns a :class:`repro_torch.core.artifact.CompressedModel`: per-unit
    compressed records, packed kernel buffers
    (``kernels.ops.pack_decomposition``), dense-effective params (each
    compressed leaf a new tensor of the old leaf's dtype and device), the
    :class:`ModelCostReport`, the per-unit plans that differ from
    ``compression`` and the pipeline's run statistics.  ``include`` filters
    unit names (callable or prefix string); ``build_packed=False`` skips the
    kernel-buffer packing.

    ``n_workers`` fans slice jobs out over worker processes (a forkserver
    pool; the result is bitwise the serial one); ``budget_adds`` invokes the
    adds-budget allocator; ``progress`` receives structured
    ``repro_torch.pipeline.CompressionEvent``s; ``cache_dir`` (durable
    slice cache), ``run_dir`` (run manifest) and ``resume`` go to
    :func:`~repro_torch.pipeline.run_pipeline`.  ``metrics`` (a
    ``repro_torch.obs.MetricsRegistry``) additionally publishes the
    pipeline's events and run stats.
    """
    import numpy as np

    from repro_torch.core.artifact import CompressedModel
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.kernels import ops
    from repro_torch.pipeline import run_pipeline

    from . import compress_adapters

    if compression is None:
        compression = CompressionConfig(algorithm="fp", weight_sharing=True,
                                        max_share_rel_err=0.06)
    sites = compress_adapters.sites_for(params, cfg)
    if include is not None:
        keep = include if callable(include) else lambda n: n.startswith(include)
        sites = [s for s in sites if keep(s.name)]
    units = compress_adapters.units_from_sites(params, sites)
    res = run_pipeline(units, compression, n_workers=n_workers,
                       budget_adds=budget_adds, cache_dir=cache_dir,
                       run_dir=run_dir, resume=resume,
                       conv_channel_subsample=conv_channel_subsample,
                       progress=progress, metrics=metrics)
    packed: dict[str, object] = {}
    params_c = params
    for site in sites:
        rec = res.records[site.name]
        if isinstance(site, compress_adapters.DenseSite):
            w = site.weight(params)
            eff = np.zeros_like(w)
            eff[:, rec.kept_columns] = rec.effective
            params_c = compress_adapters.rebind_site(params_c, site, eff)
            if build_packed:
                packed[site.name] = ops.pack_decomposition(rec.decomposition)
        else:
            kernel = site.kernel(params)
            eff_k = compress_adapters.effective_conv_kernel(
                kernel, rec, res.unit_configs[site.name].conv_method)
            params_c = compress_adapters.rebind_site(params_c, site, eff_k)
    # record only plans that differ from the global config (allocator output)
    unit_configs = {n: c for n, c in res.unit_configs.items() if c != compression}
    return CompressedModel(config=cfg, params=params_c, records=res.records,
                           packed=packed, report=res.report,
                           compression=compression, unit_configs=unit_configs,
                           pipeline_stats=res.stats)
