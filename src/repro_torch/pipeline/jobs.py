"""Job-graph planner: compressible units -> content-addressed slice jobs.

The planner runs the cheap, inherently-sequential *prepare* stage per unit
(prune + affinity-propagation clustering + slice planning, see
``core.compress.prepare_dense`` / ``prepare_conv``) and emits one job per
column slice (dense) or per input channel (conv) — the hot sequential loop of
``lcc_decompose`` today, and embarrassingly parallel by construction: slices
only meet again in the final sum over slice outputs.

Every job is a pure function of (matrix, knobs), carries a deterministic
``job_id`` (unit order x slice order) for the sort-by-job-id reduction, and a
:func:`repro_torch.pipeline.cache.job_key` content address so tied/shared
weights and re-runs are free.  Counterpart of ``repro.pipeline.jobs``; this
module is what the worker pool's forkserver preloads, so it touches no CUDA
state.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass

import numpy as np

from dataclasses import field as _field

from repro_torch.core.compress import (CompressibleConv, CompressibleDense,
                                       CompressionConfig, PreparedConv,
                                       PreparedDense, conv_channel_decompose,
                                       prepare_conv, prepare_dense,
                                       slice_job_plan)
from repro_torch.core.lcc import lcc_decompose_slice

from .cache import job_key

__all__ = ["SliceJob", "PlannedUnit", "Planner", "execute_job",
           "execute_job_batch"]

# knob subset a conv-channel job needs (must be CompressionConfig field names)
_CONV_KNOBS = ("algorithm", "s_terms", "frac_bits", "target_snr_db",
               "snr_offset_db", "slice_width", "max_factors",
               "max_terms_per_row")


@dataclass
class SliceJob:
    """One decomposition job: ``mat`` under ``knobs``.

    kind 'dense_slice': one column slice of a prepared dense target
    (``knobs['target_snr_db']`` is already resolved, so the job never sees the
    whole matrix).  kind 'conv_channel': one input channel's FK/PK matrix.
    """

    job_id: int
    unit: str
    kind: str  # 'dense_slice' | 'conv_channel'
    index: int  # slice index (dense) or channel id (conv)
    mat: np.ndarray
    knobs: dict
    cache_key: str
    keep: np.ndarray | None = None  # shrunk dense job: surviving column
                                    # offsets within the slice; mat is
                                    # compacted to them


@dataclass
class PlannedUnit:
    name: str
    kind: str  # 'dense' | 'conv'
    cfg: CompressionConfig
    prep: PreparedDense | PreparedConv
    jobs: list[SliceJob]
    prep_wall_s: float
    skipped: list[int] = _field(default_factory=list)  # all-dead slice indices
    shrunk: int = 0  # jobs compacted to surviving columns
    dead_groups: int = 0  # dead columns (dense) / channels (conv) detected


def execute_job(kind: str, mat: np.ndarray, knobs: dict):
    """Run one job (worker entry point — top-level for pickling).  Returns
    ``(piece, wall_seconds)``; the piece is an LCCChain/FSProgram for dense
    slices, a whole LCCDecomposition for conv channels."""
    t0 = time.time()
    if kind == "dense_slice":
        piece = lcc_decompose_slice(
            mat, knobs["algorithm"], knobs["target_snr_db"],
            s_terms=knobs["s_terms"], max_factors=knobs["max_factors"],
            max_terms_per_row=knobs["max_terms_per_row"])
    elif kind == "conv_channel":
        piece = conv_channel_decompose(mat, CompressionConfig(**knobs))
    else:
        raise ValueError(f"unknown job kind {kind!r}")
    return piece, time.time() - t0


def execute_job_batch(batch: list[tuple[str, np.ndarray, dict]]):
    """Run a chunk of jobs in one worker round-trip (amortizes the per-future
    submit/pickle overhead, which otherwise dominates at ~10ms/job)."""
    return [execute_job(kind, mat, knobs) for kind, mat, knobs in batch]


def _plan_cache_token(name: str, cfg: CompressionConfig) -> str:
    return name + "|" + json.dumps(asdict(cfg), sort_keys=True, default=str)


class Planner:
    """Walks units in order, prepares each under its per-unit plan, and emits
    the flat job list with globally sequential ids.

    ``prep_memo`` (shared across allocator candidate evaluations and the final
    assembly pass) memoizes the prepare stage per (unit, config), so the
    clustering work is paid once per distinct plan, not once per evaluation.
    """

    def __init__(self, conv_channel_subsample: int | None = None,
                 prep_memo: dict | None = None):
        self.conv_channel_subsample = conv_channel_subsample
        self.prep_memo = prep_memo if prep_memo is not None else {}

    def plan(self, units, plans: dict[str, CompressionConfig],
             emit=None) -> list[PlannedUnit]:
        planned: list[PlannedUnit] = []
        jid = 0
        for u in units:
            cfg = plans[u.name]
            token = _plan_cache_token(u.name, cfg)
            t0 = time.time()
            prep = self.prep_memo.get(token)
            fresh = prep is None
            if emit:  # even when the prepare stage is memoized: an observed
                emit("unit_start", unit=u.name)  # pass still walks the unit
            if isinstance(u, CompressibleDense):
                if prep is None:
                    prep = prepare_dense(u.name, u.weight, cfg)
                jobs = []
                skipped: list[int] = []
                shrunk = 0
                dead = 0
                entries = slice_job_plan(prep, cfg)
                have = {e[0] for e in entries}
                for si, (c0, c1) in enumerate(prep.col_slices):
                    if si not in have:
                        skipped.append(si)
                        dead += c1 - c0
                        if emit:
                            emit("skip", unit=u.name,
                                 detail=f"slice {si}: all {c1 - c0} columns "
                                        "dead, 0 adds")
                for si, (c0, c1), mat, keep in entries:
                    mat = np.ascontiguousarray(mat)
                    if keep is not None:
                        shrunk += 1
                        dead += (c1 - c0) - int(keep.size)
                    knobs = {"algorithm": cfg.algorithm,
                             "target_snr_db": prep.target_snr_db,
                             "s_terms": cfg.s_terms,
                             "max_factors": cfg.max_factors,
                             "max_terms_per_row": cfg.max_terms_per_row}
                    jobs.append(SliceJob(
                        job_id=jid, unit=u.name, kind="dense_slice", index=si,
                        mat=mat, knobs=knobs,
                        cache_key=job_key(mat, {"kind": "dense_slice", **knobs}),
                        keep=keep))
                    jid += 1
                kind = "dense"
            elif isinstance(u, CompressibleConv):
                if prep is None:
                    prep = prepare_conv(u.name, u.kernel, cfg,
                                        self.conv_channel_subsample)
                jobs = []
                skipped = []
                shrunk = 0
                dead = prep.kernel_shape[1] - len(prep.ch_nonzero)
                if dead and emit:
                    emit("skip", unit=u.name,
                         detail=f"{dead} dead input channels dropped, 0 adds")
                cfg_d = asdict(cfg)
                knobs = {k: cfg_d[k] for k in _CONV_KNOBS}
                for ch in prep.sel:
                    mat = np.ascontiguousarray(prep.mats[ch])
                    jobs.append(SliceJob(
                        job_id=jid, unit=u.name, kind="conv_channel", index=ch,
                        mat=mat, knobs=knobs,
                        cache_key=job_key(mat, {"kind": "conv_channel", **knobs})))
                    jid += 1
                kind = "conv"
            else:
                raise TypeError(f"unknown compressible unit {type(u)}")
            self.prep_memo.pop(token, None)  # refresh insertion order (FIFO)
            self.prep_memo[token] = prep
            planned.append(PlannedUnit(
                name=u.name, kind=kind, cfg=cfg, prep=prep, jobs=jobs,
                prep_wall_s=(time.time() - t0) if fresh else 0.0,
                skipped=skipped, shrunk=shrunk, dead_groups=dead))
        # bound the memo: a budget search probes ~20 configs per unit, and a
        # prepared unit can hold a full-matrix target — evict oldest (prepare
        # is recomputable; eviction only costs a re-cluster on a rare revisit).
        # ~2 entries per unit keeps the current plan set plus one probe plan
        # resident, i.e. about one extra model copy, not four
        cap = max(32, 2 * len(units))
        while len(self.prep_memo) > cap:
            self.prep_memo.pop(next(iter(self.prep_memo)))
        return planned
