"""Adds-budget allocator: per-unit rate allocation under a global additions
budget (the paper's whole objective — minimize adds — made a first-class
constraint, in the spirit of Deep Compression's per-layer rate allocation).

Search strategy
---------------
Every unit gets a small **candidate ladder** of configs ordered cheap->rich
(:func:`candidate_ladder`): the knobs are the LCC algorithm (FS compresses
harder than FP at equal fidelity), the fidelity target (``snr_offset_db``
against the CSD-matched SNR), the per-row term budget ``s_terms``, the prune
threshold and the weight-sharing acceptance bound.  All (unit x level)
candidates are evaluated through the pipeline's job graph — fully parallel,
and content-addressed so repeated levels and re-runs are free — yielding the
exact per-unit cost curve (``lcc`` adds from the :class:`ModelCostReport`)
and quality curve (achieved SNR).

Selection is the classic marginal-utility greedy for rate allocation: start
every unit at its cheapest level, then repeatedly apply the single upgrade
with the best  d(quality)/d(adds)  ratio that still fits the budget, where
quality is achieved SNR weighted by the unit's signal energy (a unit holding
10x the energy of another contributes 10x per dB to end-to-end fidelity).
Upgrades that *save* adds without losing quality are taken unconditionally.

The ladder is discrete, so the greedy alone can leave slack of up to one
upgrade step.  A final **trim** pass closes it by binary-searching three
continuous dials per remaining unit — the shared-cluster count (the bridge
across the ladder's biggest structural jump, sharing vs none), the current
level's ``snr_offset_db`` upward, and the next level's downward — and keeping
whichever spends the most leftover budget.  Each probe re-evaluates a single
unit (every other unit is a content-addressed cache hit), so the search lands
within ``trim_tol`` (default 5%) of the requested budget whenever the dials
have that much range.  Counterpart of ``repro.pipeline.allocator``: the same
ladder, greedy and trim, so both packages choose the same plans.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from repro_torch.core.compress import (CompressedDense, CompressibleDense,
                                       CompressionConfig)

__all__ = ["candidate_ladder", "allocate_budget"]

_SNR_CAP_DB = 120.0  # exact reconstructions report inf; cap for arithmetic


def _prune_at_least(base_tol: float, floor: float) -> float:
    """Raise the pruning threshold magnitude to ``floor``, preserving the
    keep-in-place convention (negative tolerance, see
    ``core.compress.prune_columns``)."""
    mag = max(abs(base_tol), floor)
    return -mag if base_tol < 0 else mag


def candidate_ladder(base: CompressionConfig) -> list[CompressionConfig]:
    """Cheap->rich per-unit plans derived from ``base``.

    level 0  FS at -9 dB, aggressive pruning, sharing always accepted — the
             adds floor;
    level 1  sparsity-first: the base knobs with group-lasso-scale pruning —
             for regularized-trained weights this harvests dead groups (0-add
             skips in the prune-aware planner) before spending on FP terms;
    level 2  FS at -4.5 dB with the base structural knobs;
    level 3  ``base`` itself (CSD-matched fidelity — the paper's operating
             point);
    level 4  one extra matching-pursuit term per row at +3 dB — the fidelity
             ceiling, for units the budget lets run rich.
    """
    return [
        replace(base, algorithm="fs", snr_offset_db=base.snr_offset_db - 9.0,
                prune_tol=_prune_at_least(base.prune_tol, 1e-4),
                max_share_rel_err=None),
        replace(base, prune_tol=_prune_at_least(base.prune_tol, 1e-3)),
        replace(base, algorithm="fs", snr_offset_db=base.snr_offset_db - 4.5),
        base,
        replace(base, s_terms=base.s_terms + 1,
                snr_offset_db=base.snr_offset_db + 3.0),
    ]


def _unit_energy(u) -> float:
    a = u.weight if isinstance(u, CompressibleDense) else u.kernel
    return float(np.sum(np.asarray(a, np.float64) ** 2))


def _achieved_snr_db(rec) -> float:
    if isinstance(rec, CompressedDense):
        snr = rec.decomposition.meta.get("achieved_snr_db")
    else:  # conv record: mean over the decomposed channels
        snrs = [d.meta.get("achieved_snr_db")
                for d in rec["decompositions"].values()]
        snrs = [s for s in snrs if s is not None]
        snr = float(np.mean(snrs)) if snrs else None
    if snr is None or not np.isfinite(snr):
        return _SNR_CAP_DB
    return min(float(snr), _SNR_CAP_DB)


def allocate_budget(units, budget_adds: int, base: CompressionConfig,
                    evaluate, emit=None, trim_tol: float = 0.05,
                    trim_probes: int = 6, max_trim_units: int | None = None
                    ) -> tuple[dict, dict]:
    """Choose one ladder level per unit so total ``lcc`` adds fit
    ``budget_adds`` at max energy-weighted SNR.

    ``evaluate(plans, tag)`` runs the job graph for one full per-unit plan
    assignment and returns ``(records, report)`` — the runner supplies it with
    the shared worker pool + cache, so the search is parallel and the final
    assembly re-uses every decomposition it produced.

    Returns ``(plans, info)``: the chosen per-unit configs and a summary dict
    (levels, adds/SNR curves, the landed total).
    """
    ladder = candidate_ladder(base)
    names = [u.name for u in units]
    energy = {u.name: _unit_energy(u) for u in units}
    e_tot = max(sum(energy.values()), 1e-30)

    # exact per-unit cost/quality curves: one pipeline evaluation per level
    adds = {n: [] for n in names}   # adds[name][level]
    util = {n: [] for n in names}   # energy-weighted SNR
    for lvl, cfg in enumerate(ladder):
        records, report = evaluate({n: cfg for n in names}, f"lvl{lvl}")
        rows = {l.name: l for l in report.layers}
        for n in names:
            adds[n].append(int(rows[n].stage_adds["lcc"]))
            util[n].append(energy[n] / e_tot * _achieved_snr_db(records[n]))

    # marginal-utility greedy, one single-level upgrade at a time
    level = {n: 0 for n in names}
    total = sum(adds[n][0] for n in names)
    if total > budget_adds and emit:
        emit("budget", detail=f"budget {budget_adds} below the adds floor "
                              f"{total}; emitting the floor plan")
    upgraded = True
    while upgraded:
        upgraded = False
        # free upgrades first: cheaper-or-equal and at least as good
        for n in names:
            l = level[n]
            while (l + 1 < len(ladder)
                   and adds[n][l + 1] - adds[n][l] <= 0
                   and util[n][l + 1] >= util[n][l]):
                total += adds[n][l + 1] - adds[n][l]
                l += 1
                level[n] = l
                upgraded = True
        # best paid upgrade that fits
        best, best_score = None, 0.0
        for n in names:
            l = level[n]
            if l + 1 >= len(ladder):
                continue
            da = adds[n][l + 1] - adds[n][l]
            du = util[n][l + 1] - util[n][l]
            if da <= 0 or du <= 0 or total + da > budget_adds:
                continue
            score = du / da
            if best is None or score > best_score:
                best, best_score = n, score
        if best is not None:
            total += adds[best][level[best] + 1] - adds[best][level[best]]
            level[best] += 1
            upgraded = True

    plans = {n: ladder[level[n]] for n in names}
    cur_adds = {n: adds[n][level[n]] for n in names}

    # ------------------------------------------------------- trim the slack
    # binary-search the continuous fidelity dial of the largest units whose
    # level is below the ceiling, spending the leftover budget
    tol = max(1.0, trim_tol * budget_adds)
    trimmed: dict[str, dict] = {}

    def probe(n, cand, tag):
        _, rep = evaluate({**plans, n: cand}, tag)
        a = next(l for l in rep.layers if l.name == n).stage_adds["lcc"]
        return a, total - cur_adds[n] + a

    if budget_adds - total > tol:
        order = sorted((n for n in names if level[n] < len(ladder) - 1),
                       key=lambda n: -cur_adds[n])
        if max_trim_units is not None:
            order = order[:max_trim_units]
        n_cols = {u.name: int(np.asarray(u.weight).shape[1]) for u in units
                  if isinstance(u, CompressibleDense)}
        for n in order:
            if budget_adds - total <= tol:
                break
            best = None  # (cfg, unit adds, new total)

            def keep(cand, a, new_total):
                nonlocal best
                if new_total <= budget_adds and (best is None or a > best[1]):
                    best = (cand, a, new_total)
                return new_total <= budget_adds

            cur_cfg = plans[n]
            # dial 1: cluster count — the continuous bridge between "a few
            # shared centroids" and "no sharing" (share_clusters >= K), the
            # biggest single adds step in the ladder
            if n in n_cols and cur_cfg.weight_sharing:
                hi_c = max(2, n_cols[n])
                hi_cfg = replace(cur_cfg, share_clusters=hi_c,
                                 max_share_rel_err=None)
                a, nt = probe(n, hi_cfg, f"trim:{n}:c{hi_c}")
                if keep(hi_cfg, a, nt):
                    pass  # even the unshared end fits: take it outright
                else:
                    lo_c = 2
                    for _ in range(trim_probes):
                        mid = (lo_c + hi_c) // 2
                        cand = replace(cur_cfg, share_clusters=mid,
                                       max_share_rel_err=None)
                        a, nt = probe(n, cand, f"trim:{n}:c{mid}")
                        if keep(cand, a, nt):
                            lo_c = mid
                        else:
                            hi_c = mid
                        if hi_c - lo_c <= 1:
                            break
            # dial 2: the current level's fidelity UP toward the budget line
            lo, hi = 0.0, 12.0
            for _ in range(trim_probes):
                mid = (lo + hi) / 2.0
                cand = replace(cur_cfg,
                               snr_offset_db=cur_cfg.snr_offset_db + mid)
                a, nt = probe(n, cand, f"trim:{n}:{mid:+.2f}dB")
                lo, hi = (mid, hi) if keep(cand, a, nt) else (lo, mid)
            # dial 3: the NEXT level's fidelity DOWN to just under the line —
            # structural knobs (sharing acceptance, fs/fp, s_terms) between
            # levels move adds in jumps no in-level dial can bridge
            nxt_cfg = ladder[level[n] + 1]
            lo, hi = 0.0, 15.0
            cand = replace(nxt_cfg, snr_offset_db=nxt_cfg.snr_offset_db - hi)
            a, nt = probe(n, cand, f"trim:{n}:next-{hi:.0f}dB")
            if keep(cand, a, nt):  # the next structure can fit at all
                for _ in range(trim_probes):
                    mid = (lo + hi) / 2.0
                    cand = replace(nxt_cfg,
                                   snr_offset_db=nxt_cfg.snr_offset_db - mid)
                    a, nt = probe(n, cand, f"trim:{n}:next-{mid:.2f}dB")
                    lo, hi = (lo, mid) if keep(cand, a, nt) else (mid, hi)
            if best is not None and best[1] > cur_adds[n]:
                plans[n], cur_adds[n], total = best[0], best[1], best[2]
                # record the winning dial's actual knobs (any of the three
                # dials may have won — algorithm/s_terms/clusters/offset)
                trimmed[n] = {"algorithm": best[0].algorithm,
                              "s_terms": best[0].s_terms,
                              "snr_offset_db": round(best[0].snr_offset_db, 3),
                              "share_clusters": best[0].share_clusters}

    info = {
        "budget_adds": int(budget_adds),
        "landed_adds": int(total),
        "levels": dict(level),  # pre-trim greedy levels; ``trimmed`` entries
                                # override these units' executed knobs
        "trimmed": trimmed,
        "ladder_size": len(ladder),
        "adds_curves": {n: list(map(int, adds[n])) for n in names},
    }
    if emit:
        emit("budget", detail=f"landed {total} adds of {budget_adds} budget "
                              f"({total / max(budget_adds, 1):.1%}); levels "
                              f"{sorted(set(level.values()))}")
    return plans, info
