"""Analytic parameter / FLOP counts per (arch, shape-cell), and the
addition counts of a compressed artifact (counterpart of
``repro.models.flops``, the same arithmetic).

``model_flops`` is the roofline's MODEL_FLOPS = 6*N*D (dense) /
6*N_active*D (MoE) term; ``attention_flops`` the quadratic score/value
FLOPs it leaves out by convention.  The dry run
(:mod:`repro_torch.launch.dryrun`) adds the two for a cell's work.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeCell

__all__ = ["param_count", "active_param_count", "model_flops",
           "attention_flops", "compressed_adds"]


def _attn_params(cfg: ArchConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    if cfg.mla is not None:
        m = cfg.mla
        return (d * cfg.n_heads * (m.qk_nope + m.qk_rope)  # q
                + d * m.kv_lora + d * m.qk_rope            # down-proj + rope key
                + m.kv_lora * cfg.n_heads * (m.qk_nope + m.v_dim)  # up-proj k,v
                + cfg.n_heads * m.v_dim * d)               # o
    return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d


def _ffn_params(cfg: ArchConfig, active_only: bool) -> int:
    d = cfg.d_model
    if cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * d * m.d_ff_expert
        routed = (m.top_k if active_only else m.n_experts) * per_expert
        shared = m.n_shared * per_expert
        router = d * m.n_experts
        return routed + shared + router
    return 3 * d * cfg.d_ff


def _mamba_params(cfg: ArchConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    h = s.d_inner // s.head_dim
    conv_dim = s.d_inner + 2 * s.d_state
    return (d * (2 * s.d_inner + 2 * s.d_state + h) + conv_dim * s.d_conv
            + 3 * h + s.d_inner + s.d_inner * d)


def _rwkv_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    tm = 5 * d * d + d * (32 * 5) + 5 * 32 * d + d * 64 + 64 * d + 2 * d
    cm = d * cfg.d_ff + cfg.d_ff * d + d * d
    return tm + cm


def _layer_params(cfg: ArchConfig, active_only: bool) -> int:
    if cfg.family == "ssm":
        return _rwkv_params(cfg)
    if cfg.family == "hybrid":
        return _mamba_params(cfg)
    return _attn_params(cfg) + _ffn_params(cfg, active_only)


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Non-embedding parameters (embedding included separately below)."""
    body = cfg.n_layers * _layer_params(cfg, active_only)
    if cfg.family == "hybrid":
        n_shared_blocks = 1  # weights shared across insertions
        body += n_shared_blocks * (_attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff)
    if cfg.enc_layers:
        body += cfg.enc_layers * (_attn_params(cfg) + 2 * cfg.d_model * cfg.d_ff)
        body += cfg.n_layers * _attn_params(cfg)  # decoder cross-attention
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return body + emb


def active_param_count(cfg: ArchConfig) -> int:
    return param_count(cfg, active_only=True)


def _hybrid_active_body(cfg: ArchConfig) -> int:
    """Hybrid compute counts the shared block once per insertion (13x), not once."""
    n_ins = cfg.n_layers // cfg.hybrid_period
    return (cfg.n_layers * _mamba_params(cfg)
            + n_ins * (_attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff))


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """6*N*D with N = active non-embedding params + lm head, D = tokens touched."""
    if cfg.family == "hybrid":
        body = _hybrid_active_body(cfg)
    else:
        body = cfg.n_layers * _layer_params(cfg, active_only=True)
        if cfg.enc_layers:
            body += cfg.enc_layers * (_attn_params(cfg) + 2 * cfg.d_model * cfg.d_ff)
            body += cfg.n_layers * _attn_params(cfg)
    head = cfg.vocab * cfg.d_model  # logits matmul
    if cell.kind == "train":
        tokens = cell.seq_len * cell.global_batch
        return 6.0 * (body + head) * tokens
    if cell.kind == "prefill":
        tokens = cell.seq_len * cell.global_batch
        return 2.0 * body * tokens  # forward only, no logits in prefill cell
    # decode: one token per sequence
    return 2.0 * (body + head) * cell.global_batch


def compressed_adds(cfg, artifact) -> dict:
    """Paper Table-1 metric for a compressed artifact: matvec *additions* per
    token at the compressed sites.

    Sourced from the artifact's :class:`~repro_torch.core.cost.ModelCostReport`
    (baseline = CSD shift-add cost of the uncompressed quantized weights, the
    paper's denominator).  MoE per-expert units are additionally reported
    with routing applied — only ``top_k / n_experts`` of each expert stack
    runs per token, so the ``active_*`` pair is the serving-time cost while
    ``baseline/compressed`` count every stored expert (the paper's storage
    view).  Returns ``{baseline_adds, compressed_adds, ratio,
    active_baseline_adds, active_compressed_adds, active_ratio}``.
    """
    moe = getattr(cfg, "moe", None)
    base = comp = a_base = a_comp = 0.0
    for lc in artifact.report.layers:
        adds = lc.stage_adds.get("lcc", lc.baseline_adds)
        scale = 1.0
        if moe is not None:
            parts = lc.name.split(".")
            if (lc.name.startswith("moe.") and parts[-1].startswith("e")
                    and parts[-1][1:].isdigit()):
                scale = moe.top_k / moe.n_experts
        base += lc.baseline_adds
        comp += adds
        a_base += lc.baseline_adds * scale
        a_comp += adds * scale
    return {
        "baseline_adds": int(round(base)),
        "compressed_adds": int(round(comp)),
        "ratio": base / comp if comp else float("inf"),
        "active_baseline_adds": int(round(a_base)),
        "active_compressed_adds": int(round(a_comp)),
        "active_ratio": a_base / a_comp if a_comp else float("inf"),
    }


def attention_flops(cfg: ArchConfig, cell: ShapeCell, causal_skip: bool = False) -> float:
    """Quadratic attention-score/value FLOPs (excluded from 6ND by convention)."""
    if cfg.family == "ssm":
        return 0.0
    s = cell.seq_len
    b = cell.global_batch
    hd = cfg.hd if cfg.mla is None else (cfg.mla.qk_nope + cfg.mla.qk_rope)
    n_attn_layers = cfg.n_layers if cfg.family != "hybrid" else cfg.n_layers // cfg.hybrid_period
    if cell.kind == "decode":
        kv = min(s, cfg.attn_window) if cfg.attn_window else s
        per = 2 * 2 * cfg.n_heads * hd * kv  # scores + values, 1 query
        return float(n_attn_layers * b * per)
    kv_span = min(s, cfg.attn_window) if cfg.attn_window else s
    per = 2 * 2 * cfg.n_heads * hd * s * kv_span
    if causal_skip and not cfg.attn_window:
        per *= 0.5
    fl = float(n_attn_layers * b * per)
    if cell.kind == "train":
        fl *= 3.0
    return fl
