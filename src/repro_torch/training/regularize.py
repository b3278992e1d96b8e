"""Compression-aware regularization: ProxSGD group layouts from the adapters
(counterpart of ``repro.training.regularize``).

The paper's Algorithm-1 step 1 (group-lasso regularized training) pays off
only if the groups the prox zeroes are exactly the groups the compressor
later slices: dense columns = input neurons (Sec. III-B).  Those are
enumerated once per family by ``models.compress_adapters``; this module
derives :class:`~repro_torch.optim.optimizers.GroupSpec` records from the
same sites.  Also the per-site sparsity report of every train step
(``sparsity_report``: device scalars, no host sync) and a host-side detailed
view (``detailed_group_report``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.optimizers import GroupSpec, spec_group_norms, tree_get

__all__ = ["site_group_specs", "sparsity_report", "detailed_group_report",
           "dead_group_fraction"]


def site_group_specs(params, cfg, lam: float,
                     include=None) -> tuple[GroupSpec, ...]:
    """One :class:`GroupSpec` per regularized *leaf*, from the family's
    compression-adapter sites.  Stacked sites (layer/expert axes) share a
    leaf and collapse into one spec whose group view covers every stacked
    copy at once.  ``include`` filters site names (callable or prefix)."""
    from repro_torch.models import compress_adapters

    sites = compress_adapters.sites_for(params, cfg)
    if include is not None:
        keep = include if callable(include) else lambda n: n.startswith(include)
        sites = [s for s in sites if keep(s.name)]
    specs: list[GroupSpec] = []
    seen: set[tuple] = set()
    for s in sites:
        if s.path in seen:
            continue  # stacked siblings share the leaf: one spec covers all
        seen.add(s.path)
        kind = "in_rows" if s.transpose else "in_cols"
        name = "/".join(str(k) for k in s.path)
        specs.append(GroupSpec(name=name, path=s.path, lam=lam, kind=kind))
    return tuple(specs)


@torch.no_grad()
def sparsity_report(params, specs) -> dict:
    """Per spec: group count, exactly-zero ("dead") group count, and the
    group-norm statistics the eq. (6) penalty is made of — 0-d device
    tensors (int32 counts, float32 norms), so a step need not sync."""
    report = {}
    for gs in specs:
        norms = spec_group_norms(tree_get(params, gs.path), gs.kind)
        report[gs.name] = {
            "groups": torch.tensor(norms.shape[0], dtype=torch.int32,
                                   device=norms.device),
            "dead": torch.sum(norms == 0.0).to(torch.int32),
            "min_norm": torch.min(norms),
            "mean_norm": torch.mean(norms),
            "penalty": gs.lam * torch.sum(norms),
        }
    return report


def dead_group_fraction(report: dict) -> float:
    """Fraction of exactly-zero groups across every reported site (reads the
    counts to the host)."""
    dead = sum(int(v["dead"]) for v in report.values())
    total = sum(int(v["groups"]) for v in report.values())
    return dead / max(total, 1)


@torch.no_grad()
def detailed_group_report(params, specs) -> dict[str, np.ndarray]:
    """Host-side per-group norms (numpy) per spec name."""
    return {gs.name: spec_group_norms(tree_get(params, gs.path), gs.kind)
            .detach().cpu().numpy()
            for gs in specs}
