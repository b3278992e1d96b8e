"""Pipeline runner: worker fan-out, cached execution, resumable runs.

Execution model
---------------
1. resolve per-unit plans (explicit ``plans`` > resumed manifest > the
   adds-budget allocator > one global config);
2. :class:`~repro_torch.pipeline.jobs.Planner` prepares units and emits the job
   graph (column-slice / conv-channel granularity);
3. jobs not satisfied by the content-addressed cache run on a process pool
   (``n_workers``); every completed job is published to the cache immediately,
   so a killed run loses at most the jobs in flight;
4. deterministic reduction: units in planner order, slices sorted by job id —
   output is bitwise-identical to the serial path regardless of worker count
   or completion order.

Resume
------
``run_dir`` holds a msgpack+crc32 ``Checkpointer`` manifest recording the
chosen per-unit plans and a content hash per unit.  ``resume=True`` restores
the manifest (so a budget run does not re-search), verifies the hashes, and
re-executes the job graph — completed slices come straight from the cache.

Counterpart of ``repro.pipeline.runner``, with the same reduction order and
the same manifest and cache files.

Worker processes never fork from the calling process, which may have
initialised CUDA: the pool runs on a *forkserver* context, a fresh process
(fork + exec) that imports :mod:`repro_torch.pipeline.jobs` once and forks
the workers from there.  Neither the job modules nor their imports touch
CUDA.
"""
from __future__ import annotations

import atexit
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.core.compress import (CompressibleDense, CompressionConfig,
                                       finish_conv, finish_dense)
from repro_torch.core.cost import ModelCostReport

from .allocator import allocate_budget
from .cache import SliceCache, job_key
from .events import EventEmitter
from .jobs import Planner, execute_job, execute_job_batch

__all__ = ["PipelineResult", "run_pipeline", "shutdown_workers"]

_MANIFEST_VERSION = 1


@dataclass
class PipelineResult:
    """What a pipeline run produced: the same ``(records, report)`` surface as
    ``compress_model_params`` plus the per-unit plans and run statistics."""

    records: dict
    report: ModelCostReport
    unit_configs: dict[str, CompressionConfig]
    stats: dict = field(default_factory=dict)
    budget_info: dict | None = None


def _unit_hash(u) -> str:
    a = u.weight if isinstance(u, CompressibleDense) else u.kernel
    return job_key(a, {"unit": u.name})


def _save_manifest(run_dir: str, units, plans, budget_adds, sub, base) -> None:
    from repro_torch.checkpoint.checkpointer import Checkpointer

    man = {
        "version": _MANIFEST_VERSION,
        "units": [u.name for u in units],
        "unit_hash": {u.name: _unit_hash(u) for u in units},
        "plans": {n: asdict(c) for n, c in plans.items()},
        "base": asdict(base),
        "budget_adds": budget_adds,
        "conv_channel_subsample": sub,
    }
    tree = {"manifest": np.frombuffer(json.dumps(man).encode(), np.uint8).copy()}
    Checkpointer(run_dir).save(0, tree, blocking=True)


def _load_manifest(run_dir: str) -> dict | None:
    from repro_torch.checkpoint.checkpointer import Checkpointer

    ckpt = Checkpointer(run_dir)
    for step in reversed(ckpt.all_steps()):
        try:
            flat = ckpt.restore_flat(step)
            man = json.loads(np.asarray(flat["manifest"], np.uint8)
                             .tobytes().decode())
        except (OSError, ValueError, KeyError) as e:
            # corrupted manifest: fall back / fresh run
            print(f"[pipeline] manifest step {step} unreadable ({e})")
            continue
        if man.get("version") == _MANIFEST_VERSION:
            return man
    return None


_forkserver_preloaded = False
_executors: dict[int, ProcessPoolExecutor] = {}


def _make_executor(n_workers: int) -> ProcessPoolExecutor:
    """Worker pool on a forkserver context: the forkserver is a fresh process
    (fork + exec, never a fork of this one, which may hold CUDA state and
    threads) that imports the job module (and torch) ONCE, then every worker
    forks cheaply from that clean single-threaded process (spawn is the
    non-POSIX fallback)."""
    global _forkserver_preloaded
    methods = multiprocessing.get_all_start_methods()
    if "forkserver" in methods:
        if not _forkserver_preloaded:
            multiprocessing.set_forkserver_preload(["repro_torch.pipeline.jobs"])
            _forkserver_preloaded = True
        ctx = multiprocessing.get_context("forkserver")
    else:
        ctx = multiprocessing.get_context("spawn")
    return ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx)


def _get_executor(n_workers: int) -> ProcessPoolExecutor:
    """Warm pool per worker count, reused across runs (slice jobs are pure
    functions, so worker reuse is free); rebuilt if a worker died."""
    ex = _executors.get(n_workers)
    if ex is None or getattr(ex, "_broken", False):
        ex = _make_executor(n_workers)
        _executors[n_workers] = ex
    return ex


@atexit.register
def shutdown_workers(wait: bool = False) -> None:
    """Stop every warm worker pool (``wait``: until its processes exit)."""
    for ex in _executors.values():
        ex.shutdown(wait=wait, cancel_futures=True)
    _executors.clear()


def _execute_jobs(jobs, cache: SliceCache, executor, emit) -> tuple[dict, dict]:
    """Run every job, cache-first.  Returns ({job_id: piece}, {job_id: wall})."""
    results: dict[int, object] = {}
    walls: dict[int, float] = {}
    pending = []
    dups: dict[int, list] = {}  # representative job_id -> identical jobs
    by_key: dict[str, object] = {}
    for j in jobs:
        piece = cache.get(j.cache_key)
        if piece is not None:
            results[j.job_id] = piece
            walls[j.job_id] = 0.0
            emit("cache_hit", unit=j.unit, detail=f"job {j.job_id}")
            continue
        rep = by_key.get(j.cache_key)
        if rep is not None:  # tied/shared weights: coalesce identical jobs
            cache.misses -= 1  # reclassified: counted a hit when it settles
            dups.setdefault(rep.job_id, []).append(j)
        else:
            by_key[j.cache_key] = j
            pending.append(j)

    def settle(j, piece, wall):
        cache.put(j.cache_key, piece)  # durable before we move on
        results[j.job_id] = piece
        walls[j.job_id] = wall
        emit("slice_done", unit=j.unit, wall_s=wall, detail=f"job {j.job_id}")
        for d in dups.get(j.job_id, ()):
            results[d.job_id] = piece
            walls[d.job_id] = 0.0
            cache.hits += 1
            emit("cache_hit", unit=d.unit, detail=f"job {d.job_id}")

    if not pending:
        return results, walls
    if executor is not None:
        # chunk to ~4 batches per worker: big enough to amortize submit/IPC,
        # small enough to keep the pool load-balanced on skewed job sizes
        n_workers = executor._max_workers
        chunk = max(1, len(pending) // (n_workers * 4))
        batches = [pending[i:i + chunk] for i in range(0, len(pending), chunk)]
        futs = {executor.submit(
                    execute_job_batch,
                    [(j.kind, j.mat, j.knobs) for j in b]): b
                for b in batches}
        for fut in as_completed(futs):
            for j, (piece, wall) in zip(futs[fut], fut.result()):
                settle(j, piece, wall)
    else:
        for j in pending:
            piece, wall = execute_job(j.kind, j.mat, j.knobs)
            settle(j, piece, wall)
    return results, walls


def _reduce(planned, results, walls, conv_channel_subsample, emit,
            finish_memo: dict | None = None):
    """Sort-by-job-id reduction, unit by unit in planner order.

    ``finish_memo`` (shared across allocator probes) memoizes the finish
    stage per (unit, plan): a trim probe changes ONE unit's plan, so the
    other units' records/cost rows — including the O(N*K) dense
    reconstruction behind ``achieved_snr_db`` — are reused, not recomputed.
    """
    from .jobs import _plan_cache_token

    report = ModelCostReport()
    records: dict[str, object] = {}
    for pu in planned:
        t0 = time.time()
        token = _plan_cache_token(pu.name, pu.cfg)
        memoized = finish_memo.get(token) if finish_memo is not None else None
        if memoized is not None:
            rec, row = memoized
            report.add(row)
        elif pu.kind == "dense":
            from repro_torch.core.lcc import expand_slice_piece, zero_slice_piece

            # rebuild by slice index: skipped (all-dead) slices get the
            # canonical zero piece, shrunk jobs are re-addressed to full slice
            # width — both pure functions of the plan, so the reduction stays
            # bitwise-deterministic at any worker count
            n_rows = pu.prep.target.shape[0]
            by_index: dict[int, object] = {}
            for j in sorted(pu.jobs, key=lambda j: j.job_id):
                piece = results[j.job_id]
                if j.keep is not None:
                    c0, c1 = pu.prep.col_slices[j.index]
                    piece = expand_slice_piece(piece, j.keep, c1 - c0)
                by_index[j.index] = piece
            pieces = [
                by_index[si] if si in by_index
                else zero_slice_piece(pu.cfg.algorithm, n_rows, c1 - c0)
                for si, (c0, c1) in enumerate(pu.prep.col_slices)
            ]
            rec = finish_dense(pu.prep, pieces, pu.cfg, report)
            row = report.layers[-1]
        else:
            decs = {j.index: results[j.job_id] for j in pu.jobs}
            rec = finish_conv(pu.prep, decs, pu.cfg, report,
                              conv_channel_subsample)
            row = report.layers[-1]
        if finish_memo is not None and memoized is None:
            finish_memo.pop(token, None)
            finish_memo[token] = (rec, row)
            while len(finish_memo) > max(32, 2 * len(planned)):
                finish_memo.pop(next(iter(finish_memo)))
        records[pu.name] = rec
        emit("unit_done", unit=pu.name,
             wall_s=pu.prep_wall_s + sum(walls[j.job_id] for j in pu.jobs)
             + (time.time() - t0),
             adds_before=row.baseline_adds,
             adds_after=row.stage_adds.get("lcc"))
    return records, report


def run_pipeline(
    units,
    compression: CompressionConfig | None = None,
    *,
    plans: dict[str, CompressionConfig] | None = None,
    budget_adds: int | None = None,
    n_workers: int = 1,
    cache_dir: str | None = None,
    run_dir: str | None = None,
    resume: bool = False,
    conv_channel_subsample: int | None = None,
    progress=None,
    metrics=None,
) -> PipelineResult:
    """Algorithm 1 over ``units`` as a parallel, resumable job graph.

    ``compression`` is the global base config (as ``compress_model_params``
    took); ``plans`` overrides it per unit; ``budget_adds`` invokes the
    allocator to *choose* per-unit plans under a global additions budget.
    ``n_workers <= 1`` executes in-process — the serial baseline the parallel
    path is bitwise-checked against.  ``cache_dir`` makes the slice cache
    durable; ``run_dir`` records the run's manifest (and, without
    ``cache_dir``, holds the cache); ``resume=True`` replays a recorded run.
    ``metrics=`` publishes the event stream and the final run stats into a
    :mod:`repro_torch.obs` registry.
    """
    t_start = time.time()
    emitter = EventEmitter(progress, metrics=metrics)
    base = compression if compression is not None else CompressionConfig()
    cache = SliceCache(cache_dir)
    if run_dir is not None and cache_dir is None:
        # resumable runs need durable slice results; default next to the manifest
        cache = SliceCache(os.path.join(run_dir, "slice_cache"))
    planner = Planner(conv_channel_subsample=conv_channel_subsample)
    budget_info = None
    by_name = {u.name: u for u in units}
    if len(by_name) != len(units):
        raise ValueError("duplicate unit names in the pipeline input")

    # ---------------------------------------------------------------- plans
    if plans is None and resume and run_dir is not None:
        man = _load_manifest(run_dir)
        if man is not None:
            if man["units"] != [u.name for u in units]:
                raise ValueError(
                    "resume manifest unit list does not match the model: "
                    f"{man['units']} vs {[u.name for u in units]}")
            stale = [n for n, h in man["unit_hash"].items()
                     if _unit_hash(by_name[n]) != h]
            if stale:
                raise ValueError(f"resume manifest weight hashes differ for "
                                 f"{stale}; refusing to mix runs")
            # resuming replays the RECORDED plans; a changed base config or
            # budget would silently not apply, so refuse like a weight mismatch
            if man.get("base") != asdict(base):
                raise ValueError(
                    "resume manifest was recorded under a different "
                    "compression config; rerun without --resume (or with the "
                    "original --config flags)")
            if man.get("budget_adds") != budget_adds:
                raise ValueError(
                    f"resume manifest budget {man.get('budget_adds')} != "
                    f"requested {budget_adds}; rerun without --resume to "
                    "re-allocate")
            if man.get("conv_channel_subsample") != conv_channel_subsample:
                raise ValueError(
                    f"resume manifest conv_channel_subsample "
                    f"{man.get('conv_channel_subsample')} != requested "
                    f"{conv_channel_subsample}; rerun without --resume")
            plans = {n: CompressionConfig(**d) for n, d in man["plans"].items()}
            budget_info = {"budget_adds": man.get("budget_adds"),
                           "resumed": True}
            emitter("resume", detail=f"{len(plans)} unit plans from manifest; "
                                     f"{len(cache)} cached slices")
    executor = _get_executor(n_workers) if n_workers > 1 else None
    try:
        if plans is None and budget_adds is not None:
            finish_memo: dict = {}

            def evaluate(eval_plans, tag):
                planned = planner.plan(units, eval_plans)
                results, walls = _execute_jobs(
                    [j for pu in planned for j in pu.jobs], cache, executor,
                    EventEmitter(None))
                records, report = _reduce(planned, results, walls,
                                          conv_channel_subsample,
                                          EventEmitter(None), finish_memo)
                emitter("budget", detail=f"evaluated candidate {tag}: "
                        f"{report.total_stage('lcc')} adds")
                return records, report

            plans, budget_info = allocate_budget(units, budget_adds, base,
                                                 evaluate, emit=emitter)
        if plans is None:
            plans = {u.name: base for u in units}
        missing = [u.name for u in units if u.name not in plans]
        if missing:
            raise KeyError(f"no plan for units {missing}")
        if run_dir is not None:
            _save_manifest(run_dir, units, plans, budget_adds,
                           conv_channel_subsample, base)

        # --------------------------------------------------------- execute
        planned = planner.plan(units, plans, emit=emitter)
        all_jobs = [j for pu in planned for j in pu.jobs]
        emitter("plan", detail=f"{len(planned)} units -> {len(all_jobs)} jobs "
                               f"({n_workers} workers)")
        # snapshot so stats report the FINAL pass's hit rate, not the
        # allocator's search traffic (tracked separately below)
        h0, m0 = cache.hits, cache.misses
        results, walls = _execute_jobs(all_jobs, cache, executor, emitter)
        records, report = _reduce(planned, results, walls,
                                  conv_channel_subsample, emitter)
    except Exception:
        # a dead pool must not poison the next run; _get_executor rebuilds
        if executor is not None and getattr(executor, "_broken", False):
            executor.shutdown(wait=False, cancel_futures=True)
            _executors.pop(n_workers, None)
        raise

    wall = time.time() - t_start
    stats = {
        "units": len(planned),
        "jobs": len(all_jobs),
        "workers": n_workers,
        "dead_groups": sum(pu.dead_groups for pu in planned),
        "skipped_jobs": sum(len(pu.skipped) for pu in planned),
        "shrunk_jobs": sum(pu.shrunk for pu in planned),
        "cache_hits": cache.hits - h0,
        "cache_misses": cache.misses - m0,
        "wall_s": round(wall, 4),
        "units_per_s": round(len(planned) / wall, 4) if wall > 0 else None,
    }
    if h0 or m0:  # allocator search traffic, reported separately
        stats["search_cache_hits"] = h0
        stats["search_cache_misses"] = m0
    if metrics is not None:
        g = metrics.gauge("pipeline_run", "final pipeline run stats",
                          labels=("stat",))
        for k, v in stats.items():
            if isinstance(v, (int, float)) and v is not None:
                g.set(v, stat=k)
    return PipelineResult(records=records, report=report, unit_configs=plans,
                          stats=stats, budget_info=budget_info)
