"""Addition counts of a compressed artifact (counterpart of the compression
half of ``repro.models.flops``; its parameter and FLOP counts for the roofline
are not part of this package yet)."""
from __future__ import annotations

__all__ = ["compressed_adds"]


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
