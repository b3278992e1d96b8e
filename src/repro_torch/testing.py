"""Fixtures, not features: a seeded compressed artifact without the compressor.

The offline compressor (prune -> share -> LCC decompose,
``models.api.compress_model``) runs for hours at full LM width.
``seeded_artifact`` builds, from a seed alone, a :class:`~repro_torch.core.artifact.CompressedModel`
with the *shape* the compressor produces — its slice grid
(``plan_col_slices``), ``S = 2`` terms per row, mostly six factors per chain
with some shorter ones (so identity padding is exercised), a few pruned
columns per site and weight sharing on some sites — whose chains are valid
LCC chains, so every runtime path (packing, the three kernels, the executor,
the engine) is driven exactly as by a real artifact.  The weights mean
nothing; the dense-effective parameters are computed from the chains, so the
kernel route and the dense route agree.  ``seeded_conv_artifact`` does the
same for the ResNet: one chain per input channel of every conv site, on the
FK or PK reshape, in conv records shaped as ``core.compress.finish_conv``
writes them.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.artifact import CompressedModel
from repro_torch.core.compress import CompressedDense, CompressionConfig
from repro_torch.core.lcc import (LCCChain, LCCDecomposition, LCCFactor,
                                  plan_col_slices)
from repro_torch.core.weight_sharing import SharedLayer
from repro_torch.kernels import ops
from repro_torch.kernels.lcc_chain_matmul import _levels_plain

__all__ = ["seeded_decomposition", "decomposition_dense", "dense_sites",
           "moe_sites", "unstacked_sites", "audio_sites", "seeded_artifact",
           "seeded_conv_artifact", "seeded_prep", "fill_cross_kv"]

SHARED_SITES = ("attn.k", "attn.o", "ffn.up", "moe.up", "tm.k", "tm.o",
                "cm.k", "mamba.in_proj", "shared_attn.attn.k",
                "shared_attn.attn.o", "shared_attn.ffn.up", "enc.attn.k",
                "dec.attn.k", "dec.xattn.o", "dec.mlp.fc1")
BIAS_SCALE = 0.5  # std of the seeded q/k/v (and whisper's fc1/fc2) biases


def _seeded_chains(n: int, k: int, rng: np.random.Generator, *,
                   s_terms: int = 2, n_factors: int = 6,
                   short_frac: float = 0.15, unused_frac: float = 0.02,
                   gain_exp: int = 0
                   ) -> tuple[LCCDecomposition, ops.PackedDecomposition]:
    """``(decomposition, packed)``; see :func:`seeded_decomposition`
    (``gain_exp`` scales the chains by ``2**gain_exp``).  The
    factors are drawn straight into the packed ``[E, P, N, S]`` layout and
    the decomposition's factors are views of those arrays, so the two share
    their memory (at full width a site's streams take hundreds of MB).  When
    the packer would pad the rows (``N`` above 128 and not a multiple of it)
    the packed copy comes from :func:`~repro_torch.kernels.ops.
    pack_decomposition` instead; either way it is bitwise the packer's."""
    cols = plan_col_slices(n, k)
    e = len(cols)
    widths = np.asarray([c1 - c0 for c0, c1 in cols], np.int64)
    e0 = int(round(math.log2(1.0 / math.sqrt(1.5 * e * s_terms))))
    e0 = max(e0 + gain_exp, -14)

    def signs(shape):
        sg = (rng.integers(0, 2, size=shape, dtype=np.int8) * 2 - 1).astype(np.int8)
        sg[rng.random(shape, dtype=np.float32) < unused_frac] = 0
        return sg

    idx0 = rng.integers(0, widths[:, None, None], size=(e, n, s_terms)
                        ).astype(np.int32)
    exp0 = (e0 + rng.integers(-1, 2, size=(e, n, s_terms))).astype(np.int8)
    sgn0 = signs((e, n, s_terms))
    later = n_factors - 1
    idx = np.empty((e, later, n, s_terms), np.int32)
    idx[..., 0] = np.arange(n, dtype=np.int32)
    idx[..., 1:] = rng.integers(0, n, size=(e, later, n, s_terms - 1),
                                dtype=np.int32)
    exp = np.zeros((e, later, n, s_terms), np.int8)
    exp[..., 1:] = -rng.integers(1, 5, size=(e, later, n, s_terms - 1),
                                 dtype=np.int8)
    sgn = np.ones((e, later, n, s_terms), np.int8)
    sgn[..., 1:] = signs((e, later, n, s_terms - 1))
    lengths = n_factors - (rng.random(e) < short_frac) * rng.integers(1, 3, size=e)
    # the packed layout: factor 0, the later factors, identity rows past a
    # chain's end (row r reads row r of the level before, sign 1)
    p_max = int(lengths.max())
    pidx = np.empty((e, p_max, n, s_terms), np.int32)
    pexp = np.empty((e, p_max, n, s_terms), np.int8)
    psgn = np.empty((e, p_max, n, s_terms), np.int8)
    pidx[:, 0], pexp[:, 0], psgn[:, 0] = idx0, exp0, sgn0
    pidx[:, 1:], pexp[:, 1:], psgn[:, 1:] = (a[:, : p_max - 1]
                                             for a in (idx, exp, sgn))
    del idx0, exp0, sgn0, idx, exp, sgn
    past = np.arange(p_max)[None, :] >= lengths[:, None]  # [E, P]
    ident_idx = np.zeros((n, s_terms), np.int32)
    ident_idx[:, 0] = np.arange(n)
    ident_sgn = np.zeros((n, s_terms), np.int8)
    ident_sgn[:, 0] = 1
    pidx[past], pexp[past], psgn[past] = ident_idx, 0, ident_sgn
    slices = []
    for ei in range(e):
        factors = [LCCFactor(pidx[ei, 0], pexp[ei, 0], psgn[ei, 0],
                             in_dim=int(widths[ei]))]
        factors += [LCCFactor(pidx[ei, p], pexp[ei, p], psgn[ei, p], in_dim=n)
                    for p in range(1, int(lengths[ei]))]
        slices.append(LCCChain(factors=factors, in_dim=int(widths[ei])))
    dec = LCCDecomposition(shape=(n, k), col_slices=cols, slices=slices,
                           algorithm="fp", target_snr_db=float("nan"),
                           meta={"fixture": True})
    if ops._pad_dim(n, 128) != n:
        return dec, ops.pack_decomposition(dec)
    w_pad = ops._pad_dim(int(widths.max()), 128)
    return dec, ops.PackedDecomposition(
        idx=pidx, exp=pexp, sign=psgn, col_slices=tuple(cols), dense=(),
        in_dim=k, out_dim=n, d_pad=max(n, w_pad), first_width=w_pad,
        chain_lengths=tuple(int(v) for v in lengths))


def seeded_decomposition(n: int, k: int, rng: np.random.Generator, *,
                         s_terms: int = 2, n_factors: int = 6,
                         short_frac: float = 0.15, unused_frac: float = 0.02
                         ) -> LCCDecomposition:
    """A valid FP decomposition of shape ``(n, k)`` on the compressor's slice
    grid.  The first factor of a slice draws ``s_terms`` of the slice's
    columns per row; later factors look like matching-pursuit refinements,
    ``prev[r] +- 2^-a * prev[j]``, so magnitudes stay bounded.  About
    ``short_frac`` of the chains are one or two factors short and about
    ``unused_frac`` of the term slots are unused (sign 0).  Scaled so that
    unit-variance inputs give roughly unit-variance outputs."""
    return _seeded_chains(n, k, rng, s_terms=s_terms, n_factors=n_factors,
                          short_frac=short_frac, unused_frac=unused_frac)[0]


@torch.no_grad()
def decomposition_dense(packed: ops.PackedDecomposition, device) -> torch.Tensor:
    """Dense equivalent ``[out_dim, in_dim]`` (float32, on ``device``) of a
    packed decomposition: every slice's chain applied to the identity of its
    width — never an N x N product."""
    w = torch.zeros((packed.out_dim, packed.in_dim), dtype=torch.float32,
                    device=device)
    if packed.col_slices:
        e, _, n_pad, _ = packed.idx.shape
        widths = [c1 - c0 for c0, c1 in packed.col_slices]
        wmax = max(widths)
        cur = torch.zeros((e, max(n_pad, wmax), wmax), dtype=torch.float32,
                          device=device)
        j = torch.arange(wmax, device=device)
        live = j[None, :] < torch.tensor(widths, device=device)[:, None]
        cur[:, j, j] = live.to(torch.float32)
        out = _levels_plain(torch.from_numpy(packed.idx).to(device),
                            torch.from_numpy(packed.exp).to(device),
                            torch.from_numpy(packed.sign).to(device), cur)
        for ei, (c0, c1) in enumerate(packed.col_slices):
            w[:, c0:c1] = out[ei, : packed.out_dim, : c1 - c0]
    for (c0, c1), wm in packed.dense:
        w[:, c0:c1] = torch.from_numpy(np.asarray(wm, np.float32)).to(device)
    return w


def dense_sites(cfg: ArchConfig) -> list[tuple[str, tuple[str, ...], int, int]]:
    """Per-layer compressible sites outside the routed experts:
    ``(site prefix, path, N out, K in)``; the site name of layer ``li`` is
    ``f"{prefix}.l{li}"`` and its weight is ``params["blocks"][path...]["w"]
    [li]`` of shape ``[K, N]``.  Attention is GQA (q/k/v/o) or MLA
    (q/dkv/kr/uk/uv/o); an MoE family lists its shared experts
    (``moe.shared.*``, path ``ffn.shared``) and leaves the routed experts to
    :func:`moe_sites`.  The ssm family lists rwkv6's time-mix r/k/v/g/o and
    channel-mix k/v/r, the hybrid its mamba in/out projections (the shared
    block's sites are :func:`unstacked_sites`).  The audio family's sites
    live outside ``blocks``: :func:`audio_sites`."""
    d, dff = cfg.d_model, cfg.d_ff
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.family == "audio":
        return []
    if cfg.family == "ssm":
        return ([(f"tm.{p}", ("tm", p), d, d) for p in ("r", "k", "v", "g", "o")]
                + [("cm.k", ("cm", "k"), dff, d), ("cm.v", ("cm", "v"), d, dff),
                   ("cm.r", ("cm", "r"), d, d)])
    if cfg.family == "hybrid":
        sc = cfg.ssm
        n_in = 2 * sc.d_inner + 2 * sc.d_state + sc.d_inner // sc.head_dim
        return [("mamba.in_proj", ("mamba", "in_proj"), n_in, d),
                ("mamba.out_proj", ("mamba", "out_proj"), d, sc.d_inner)]
    if cfg.mla is not None:
        m = cfg.mla
        sites = [("attn.q", ("attn", "q"), nq * (m.qk_nope + m.qk_rope), d),
                 ("attn.dkv", ("attn", "dkv"), m.kv_lora, d),
                 ("attn.kr", ("attn", "kr"), m.qk_rope, d),
                 ("attn.uk", ("attn", "uk"), nq * m.qk_nope, m.kv_lora),
                 ("attn.uv", ("attn", "uv"), nq * m.v_dim, m.kv_lora),
                 ("attn.o", ("attn", "o"), d, nq * m.v_dim)]
    else:
        sites = [("attn.q", ("attn", "q"), nq * hd, d),
                 ("attn.k", ("attn", "k"), nkv * hd, d),
                 ("attn.v", ("attn", "v"), nkv * hd, d),
                 ("attn.o", ("attn", "o"), d, nq * hd)]
    if cfg.moe is None:
        sites += [("ffn.gate", ("ffn", "gate"), dff, d),
                  ("ffn.up", ("ffn", "up"), dff, d),
                  ("ffn.down", ("ffn", "down"), d, dff)]
    elif cfg.moe.n_shared > 0:
        sff = cfg.moe.n_shared * cfg.moe.d_ff_expert
        sites += [("moe.shared.gate", ("ffn", "shared", "gate"), sff, d),
                  ("moe.shared.up", ("ffn", "shared", "up"), sff, d),
                  ("moe.shared.down", ("ffn", "shared", "down"), d, sff)]
    return sites


def moe_sites(cfg: ArchConfig) -> list[tuple[str, str, int, int]]:
    """Per-layer expert sites of the MoE family: ``(site prefix, projection,
    N out, K in)``; expert ``e`` of layer ``li`` is ``f"{prefix}.l{li}.e{e}"``
    and its weight ``params["blocks"]["ffn"][projection][li, e]`` of shape
    ``[K, N]`` (raw expert stacks, no ``"w"`` level, as in the reference)."""
    if cfg.moe is None:
        return []
    d, dff = cfg.d_model, cfg.moe.d_ff_expert
    return [("moe.gate", "gate", dff, d), ("moe.up", "up", dff, d),
            ("moe.down", "down", d, dff)]


def unstacked_sites(cfg: ArchConfig) -> list[tuple[str, tuple[str, ...], int, int]]:
    """Compressible sites outside the layer stack: ``(site name, path from
    the params root, N out, K in)``, weight ``params[path...]["w"]`` of
    shape ``[K, N]``.  The hybrid's weight-shared attention + SwiGLU block
    (``shared_attn.*``, one site a projection for every insertion); no other
    family has any."""
    if cfg.family != "hybrid":
        return []
    d, dff = cfg.d_model, cfg.d_ff
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dims = {"attn": {"q": (nq * hd, d), "k": (nkv * hd, d),
                     "v": (nkv * hd, d), "o": (d, nq * hd)},
            "ffn": {"gate": (dff, d), "up": (dff, d), "down": (d, dff)}}
    return [(f"shared_attn.{part}.{p}", ("shared_attn", part, p), n, k)
            for part in ("attn", "ffn") for p, (n, k) in dims[part].items()]


def audio_sites(cfg: ArchConfig) -> list[tuple[str, tuple[str, ...], int, int]]:
    """The audio family's stacked sites in the reference's order:
    ``(site prefix, path from the params root, N out, K in)``; the site of
    layer ``li`` is ``f"{prefix}.l{li}"`` and its weight ``params[path...]
    ["w"][li]`` of shape ``[K, N]``, over ``enc_layers`` layers for the
    encoder's ``enc.*`` prefixes and ``n_layers`` for the decoder's
    ``dec.*``.  No other family has any."""
    if cfg.family != "audio":
        return []
    d, dff = cfg.d_model, cfg.d_ff
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = (("q", nq * hd, d), ("k", nkv * hd, d), ("v", nkv * hd, d),
            ("o", d, nq * hd))
    out = []
    for part, parts in (("enc", ("attn",)), ("dec", ("attn", "xattn"))):
        blocks = f"{part}_blocks"
        out += [(f"{part}.mlp.{p}", (blocks, "mlp", p), n, k)
                for p, n, k in (("fc1", dff, d), ("fc2", d, dff))]
        out += [(f"{part}.{a}.{p}", (blocks, a, p), n, k)
                for a in parts for p, n, k in attn]
    return out


def _audio_layers(cfg: ArchConfig, prefix: str) -> int:
    return cfg.enc_layers if prefix.startswith("enc.") else cfg.n_layers


def _audio_tree(cfg: ArchConfig, rng: np.random.Generator, pd: dict) -> dict:
    """Whisper's parameter tree without its site weights: the LayerNorms
    (scales one, biases zero) and the learned decoder positions, drawn from
    ``rng`` as the reference initialises them."""
    d = cfg.d_model

    def ln(*lead):
        return {"w": torch.ones((*lead, d), **pd),
                "b": torch.zeros((*lead, d), **pd)}

    pos = rng.standard_normal((cfg.max_decoder_len, d), dtype=np.float32)
    return {"enc_blocks": {"ln1": ln(cfg.enc_layers), "ln2": ln(cfg.enc_layers)},
            "enc_ln": ln(),
            "dec_blocks": {"ln1": ln(cfg.n_layers), "ln2": ln(cfg.n_layers),
                           "ln_x": ln(cfg.n_layers)},
            "dec_ln": ln(),
            "dec_pos": torch.from_numpy(pos * np.float32(0.01)).to(**pd)}


def _recurrent_tree(cfg: ArchConfig, seed: int, device) -> dict:
    """The ssm or hybrid parameter tree without its site weights (None
    there): the embedding's and head's places, the norms, and the
    recurrent blocks' small leaves drawn as the reference initialises them
    from a generator of their own (``F32_LEAVES`` float32, the rest in
    ``cfg.param_dtype``)."""
    from repro_torch.convert import F32_LEAVES
    from repro_torch.models import transformer

    rng = np.random.default_rng((seed, 0, 2))
    d = cfg.d_model

    def normal(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    def const(shape, value):
        return np.full(shape, value, np.float32)

    def none(shape, scale):
        return None

    fn = (transformer.rwkv6_block_tree if cfg.family == "ssm"
          else transformer.mamba2_block_tree)
    tree = {"final_ln": const((d,), 1.0),
            "blocks": fn(cfg, normal, none, const)}
    if cfg.family == "hybrid":
        tree["shared_attn"] = transformer.shared_attn_tree(cfg, none, const)

    def to_tensors(t, dtype):
        if isinstance(t, dict):
            return {k: to_tensors(v, torch.float32 if k in F32_LEAVES else dtype)
                    for k, v in t.items()}
        return None if t is None else torch.from_numpy(t).to(device=device,
                                                             dtype=dtype)

    return to_tensors(tree, cfg.pdtype)


def seeded_prep(k: int, rng: np.random.Generator, shared: bool,
                n_pruned: int = 2) -> tuple[np.ndarray, np.ndarray | None, int]:
    """A site's input preparation as the fixture draws it: ``(kept, labels,
    K_dec)`` — ``n_pruned`` columns pruned at random and, when ``shared``, a
    sixteenth of the kept columns merged into other columns' clusters
    (``labels`` None otherwise; ``K_dec`` the decomposition's input width)."""
    n_pruned = min(n_pruned, k - 2)
    kept = np.sort(rng.permutation(k)[n_pruned:]).astype(np.int64)
    k_dec, labels = kept.size, None
    if shared:
        merged = max(1, kept.size // 16)
        k_dec = kept.size - merged
        labels = np.concatenate([rng.permutation(k_dec),
                                 rng.integers(0, k_dec, size=merged)])
        labels = labels[rng.permutation(labels.size)].astype(np.int64)
    return kept, labels, k_dec


def _seeded_site(name: str, n: int, k: int, rng: np.random.Generator,
                 shared: bool, n_pruned: int, device, host_effective: bool):
    """One site: record, packed buffers and the full dense-effective weight
    ``[N, K]`` (pruned columns zero) on ``device``."""
    kept, labels, k_dec = seeded_prep(k, rng, shared, n_pruned)
    dec, packed = _seeded_chains(n, k_dec, rng)
    w_dec = decomposition_dense(packed, device)  # [N, k_dec]
    eff = w_dec if labels is None else w_dec[:, torch.from_numpy(labels).to(device)]
    full = torch.zeros((n, k), dtype=torch.float32, device=device)
    full[:, torch.from_numpy(kept).to(device)] = eff
    rec = CompressedDense(
        name=name, kept_columns=kept,
        shared=(SharedLayer(centroids=w_dec.cpu().numpy(), labels=labels)
                if labels is not None else None),
        decomposition=dec,
        effective=eff.cpu().numpy() if host_effective else None)
    return rec, packed, full


def seeded_artifact(cfg: ArchConfig, seed: int = 0, device="cuda", *,
                    shared_sites=SHARED_SITES, n_pruned: int = 2,
                    host_effective: bool = True) -> CompressedModel:
    """A compressed artifact for ``cfg`` made from ``seed`` alone (see the
    module docstring).  Every attention and FFN projection of every layer —
    for the MoE family every expert's gate, up and down and the shared
    experts' — is a compressed site (MLA: q, dkv, kr, uk, uv, o; ssm:
    rwkv6's mixes; hybrid: mamba's in/out projections and the shared
    block's, see :func:`unstacked_sites`); the recurrent blocks' other
    leaves are drawn as the reference initialises them, from a generator
    of their own; audio: every site of :func:`audio_sites`, the encoder's
    included, beside the LayerNorms and the learned positions;
    ``shared_sites`` (site prefixes) additionally get weight sharing,
    so the segment-sum kernel is on the decode path.  An MoE block gets a
    seeded float32 router ``[L, d, E]``; a ``qkv_bias`` model gets seeded
    non-zero q/k/v biases ``[L, out]`` (std ``BIAS_SCALE``, from a generator
    of their own, so every other leaf is what it is without them), and so
    does whisper, on q/k/v and fc1/fc2 of every layer (o has none).
    ``params`` are the dense-effective
    weights in ``cfg.param_dtype`` (``convert.F32_LEAVES`` in float32) on
    ``device``;
    pre-packed kernel buffers come along in ``packed``.  With
    ``host_effective=False`` the records keep no host copy of their
    dense-effective matrix (``effective`` is None: at mixtral-8x22b's width
    it would take 10 GB a layer; ``params`` hold the same weights).  Sites
    are drawn on up to 8 threads, each from its own generator, so the
    artifact does not depend on the thread count."""
    sites = dense_sites(cfg)
    L, d = cfg.n_layers, cfg.d_model
    rng = np.random.default_rng((seed, 0))
    pd = dict(dtype=cfg.pdtype, device=device)
    embed = rng.standard_normal((cfg.vocab, d), dtype=np.float32) * np.float32(d ** -0.5)
    if cfg.family == "audio":
        params = {"embed": torch.from_numpy(embed).to(**pd),
                  **_audio_tree(cfg, rng, pd)}
    elif cfg.family in ("ssm", "hybrid"):
        params = {"embed": torch.from_numpy(embed).to(**pd),
                  **_recurrent_tree(cfg, seed, device)}
    else:
        params = {"embed": torch.from_numpy(embed).to(**pd),
                  "final_ln": torch.ones((d,), **pd),
                  "blocks": {"ln1": torch.ones((L, d), **pd),
                             "ln2": torch.ones((L, d), **pd),
                             "attn": {}, "ffn": {}}}
    if not cfg.tie_embeddings and cfg.family != "audio":  # whisper reads embed
        head = rng.standard_normal((d, cfg.vocab), dtype=np.float32) * np.float32(d ** -0.5)
        params["lm_head"] = {"w": torch.from_numpy(head).to(**pd)}
    # one job a site: (name, N, K, generator key, weight-shared, where the
    # dense-effective weight goes in params)
    jobs = []
    for si, (prefix, path, n, k) in enumerate(sites):
        node = params["blocks"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {"w": torch.empty((L, k, n), **pd)}
        for li in range(L):
            jobs.append((f"{prefix}.l{li}", n, k, (seed, 1 + li, si),
                         prefix in shared_sites,
                         (node[path[-1]]["w"], (li,))))
    for si, (name, path, n, k) in enumerate(unstacked_sites(cfg)):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {"w": torch.empty((k, n), **pd)}
        jobs.append((name, n, k, (seed, 0, 3, si), name in shared_sites,
                     (node[path[-1]]["w"], ())))
    for si, (prefix, path, n, k) in enumerate(audio_sites(cfg), len(sites)):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        n_l = _audio_layers(cfg, prefix)
        node[path[-1]] = {"w": torch.empty((n_l, k, n), **pd)}
        for li in range(n_l):
            jobs.append((f"{prefix}.l{li}", n, k, (seed, 1 + li, si),
                         prefix in shared_sites, (node[path[-1]]["w"], (li,))))
    if cfg.family == "audio":  # biases from a generator of their own
        brng = np.random.default_rng((seed, 0, 4))
        for prefix, path, n, _ in audio_sites(cfg):
            if path[-1] != "o":
                b = brng.standard_normal((_audio_layers(cfg, prefix), n),
                                         dtype=np.float32)
                params[path[0]][path[1]][path[2]]["b"] = torch.from_numpy(
                    b * np.float32(BIAS_SCALE)).to(**pd)
    if cfg.qkv_bias:  # a generator of their own: other configs stay as they were
        brng = np.random.default_rng((seed, 0, 1))
        for proj, n in (("q", cfg.n_heads * cfg.hd), ("k", cfg.n_kv_heads * cfg.hd),
                        ("v", cfg.n_kv_heads * cfg.hd)):
            b = brng.standard_normal((L, n), dtype=np.float32) * np.float32(BIAS_SCALE)
            params["blocks"]["attn"][proj]["b"] = torch.from_numpy(b).to(**pd)
    if cfg.moe is not None:
        ne = cfg.moe.n_experts
        ffn = params["blocks"]["ffn"]
        router = rng.standard_normal((L, d, ne), dtype=np.float32) * np.float32(d ** -0.5)
        ffn["router"] = torch.from_numpy(router).to(device)
        for si, (prefix, proj, n, k) in enumerate(moe_sites(cfg), len(sites)):
            ffn[proj] = torch.empty((L, ne, k, n), **pd)
            for li in range(L):
                for e in range(ne):
                    jobs.append((f"{prefix}.l{li}.e{e}", n, k,
                                 (seed, 1 + li, si, e), prefix in shared_sites,
                                 (ffn[proj], (li, e))))

    def run(job):
        name, n, k, key, shared, (stack, at) = job
        rec, pk, full = _seeded_site(name, n, k, np.random.default_rng(key),
                                     shared, n_pruned, device, host_effective)
        stack[at] = full.T.to(cfg.pdtype)
        return name, rec, pk

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        built = list(pool.map(run, jobs))  # numpy and torch free the GIL
    # executor site order follows the JAX adapters': layer-major inside a site
    records = {name: rec for name, rec, _ in built}
    packed = {name: pk for name, _, pk in built}
    return CompressedModel(
        config=cfg, params=params, records=records, packed=packed,
        compression=CompressionConfig(algorithm="fp", weight_sharing=True),
        pipeline_stats={"fixture": "seeded", "seed": seed})


def seeded_conv_artifact(cfg, seed: int = 0, device="cuda", *,
                         method: str = "fk", head_pruned: int = 2
                         ) -> CompressedModel:
    """A compressed ResNet artifact for ``cfg`` (a ``ResNetConfig``) made
    from ``seed`` alone.  Every input channel of every conv site (the stem,
    each block's conv1/conv2 and ``proj``) has a valid chain on the
    compressor's slice grid for its ``method`` matrix (FK ``[N, O*O]``, PK
    ``[N*O, O]``), scaled by about ``1/sqrt(C_in)`` so a conv's output keeps
    its input's scale; the records are ``finish_conv``'s dicts (every
    channel decomposed, ``scale`` 1, ``lcc_adds`` from the chains,
    ``baseline_adds`` 0: there is no dense original).  The head is a
    compressed dense site with ``head_pruned`` pruned columns (so its input
    goes through the region prep).  ``params`` are the dense-effective
    weights (what ``models.compress_adapters.effective_conv_kernel`` gives)
    in ``cfg.dtype`` on ``device``: GroupNorm scales one, head bias zero.
    Each site is drawn from its own generator."""
    from repro_torch.core.conv_reshape import conv_layer_adds
    from repro_torch.models import compress_adapters as ca
    from repro_torch.models.resnet import init_resnet

    def dense(dec):
        """The chains applied to the identity of each slice's width: the
        decomposition's dense matrix without ``to_dense``'s N x N factor
        products (7,555 channels at ResNet-34's width)."""
        w = np.zeros(dec.shape)
        for (c0, c1), chain in zip(dec.col_slices, dec.slices):
            w[:, c0:c1] = chain.apply(np.eye(c1 - c0))
        return w

    dt = getattr(torch, cfg.dtype)
    shapes = init_resnet(torch.Generator().manual_seed(seed), cfg, "meta")
    sites = ca.sites_for(shapes, cfg)
    convs = [s for s in sites if isinstance(s, ca.ConvSite)]

    def run(job):
        si, site = job
        n, k, o, _ = ca._lookup(shapes, site.path).shape
        rows, cols = (n, o * o) if method == "fk" else (n * o, o)
        rng = np.random.default_rng((seed, 1 + si))
        gain = -int(round(0.5 * math.log2(k)))
        decs = {ch: _seeded_chains(rows, cols, rng, gain_exp=gain)[0]
                for ch in range(k)}
        lcc = conv_layer_adds([d.num_adds() for d in decs.values()], n, o,
                              method, k)
        rec = {"decompositions": decs, "channels_nonzero": list(range(k)),
               "baseline_adds": 0, "lcc_adds": lcc, "scale": 1.0}
        # the FK/PK reshape inverted, as effective_conv_kernel inverts it
        mats = np.stack([dense(decs[ch]) for ch in range(k)])
        eff = mats.reshape(k, n, o, o).transpose(
            (1, 0, 2, 3) if method == "fk" else (1, 0, 3, 2))
        return site, rec, torch.from_numpy(np.ascontiguousarray(eff)).to(
            device=device, dtype=dt)

    # one thread: the channels are small numpy calls, and threads contend
    # for the interpreter lock (8 threads took 5x as long as one)
    built = [run(job) for job in enumerate(convs)]
    params = {"stem": None, "blocks": [
        {k: (torch.ones(v.shape, dtype=dt, device=device)
             if k.startswith("gn") else None) for k, v in blk.items()}
        for blk in shapes["blocks"]]}
    records = {}
    for site, rec, eff in built:
        params = ca._set_in(params, site.path, eff)
        records[site.name] = rec
    c = cfg.widths[-1]
    head, pk, full = _seeded_site("head", cfg.classes, c,
                                  np.random.default_rng((seed, 0)), False,
                                  head_pruned, device, True)
    params["head"] = {"w": full.to(dt),
                      "b": torch.zeros((cfg.classes,), dtype=dt, device=device)}
    records["head"] = head
    return CompressedModel(
        config=cfg, params=params, records=records, packed={"head": pk},
        compression=CompressionConfig(algorithm="fp", conv_method=method,
                                      weight_sharing=False),
        pipeline_stats={"fixture": "seeded", "seed": seed})


@torch.no_grad()
def fill_cross_kv(params, cfg: ArchConfig, state, slot: int, frames) -> None:
    """Write slot ``slot``'s static cross-KV into a whisper decode state, the
    reference's recipe (its ``test_whisper_decode_consistency``): ``frames``
    [S, d] through ``whisper.encode``, then each decoder layer's
    ``xattn.k``/``xattn.v`` (the dense weights in ``params``, biases
    included) into ``state["cross_k"/"cross_v"][layer, slot]``.  ``S``
    must be the state's encoder length: cross-attention masks no row.  A
    test and benchmark helper, not an engine feature: the engine leaves the
    cross-KV to its caller."""
    from repro_torch.models.layers import linear
    from repro_torch.models.whisper import encode

    s = frames.shape[0]
    if s != state["cross_k"].shape[2]:
        raise ValueError(f"{s} frames for a cross-KV of "
                         f"{state['cross_k'].shape[2]} encoder positions")
    enc = encode(params, cfg, frames[None])[0]
    xattn = params["dec_blocks"]["xattn"]
    for li in range(cfg.n_layers):
        for leaf, proj in (("cross_k", "k"), ("cross_v", "v")):
            p = {n: t[li] for n, t in xattn[proj].items()}
            state[leaf][li, slot] = linear(p, enc).reshape(
                s, cfg.n_kv_heads, cfg.hd).to(state[leaf].dtype)
