"""Algorithm 1: the complete NN compression procedure for LCC.

    1. regularized (group-lasso, proximal) training      -> repro_torch.optim.prox_sgd
    2. affinity-propagation clustering + tied retraining -> weight_sharing
    3. LCC decomposition of every (equivalent) matrix    -> lcc

This module orchestrates steps 2-3 on trained parameters and produces the
per-layer cost report; step 1 happens inside the training loop (the prox is an
optimizer transform).  It is model-agnostic: a model exposes *compressible
units* (dense matrices or conv kernels) through small adapter records.

Numpy throughout, the reference's (``repro.core.compress``) operation for
operation, so both packages produce bitwise the same records and reports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from .conv_reshape import conv_fk_matrices, conv_layer_adds, conv_pk_matrices
from .cost import LayerCost, ModelCostReport, shared_layer_adds
from .csd import adds_csd_matrix
from .lcc import (LCCChain, FSProgram, LCCDecomposition, lcc_decompose,
                  lcc_decompose_slice, plan_col_slices, resolve_target_snr_db,
                  assemble_decomposition, expand_slice_piece, zero_slice_piece)
from .weight_sharing import SharedLayer, cluster_columns, cluster_columns_fixed

__all__ = [
    "CompressionConfig",
    "CompressibleDense",
    "CompressibleConv",
    "CompressedDense",
    "PreparedDense",
    "PreparedConv",
    "prepare_dense",
    "finish_dense",
    "prepare_conv",
    "finish_conv",
    "conv_channel_decompose",
    "compress_dense_matrix",
    "compress_conv_kernel",
    "compress_model_params",
    "prune_columns",
    "slice_job_plan",
]


@dataclass
class CompressionConfig:
    algorithm: str = "fs"  # 'fp' | 'fs'
    s_terms: int = 2
    frac_bits: int = 8
    target_snr_db: float | None = None  # None => match CSD quantization SNR
    snr_offset_db: float = 0.0  # allocator knob: fidelity delta vs the
                                # resolved target (negative => cheaper/lossier)
    slice_width: int | None = None
    weight_sharing: bool = True
    share_damping: float = 0.7
    share_preference: float | None = None
    share_clusters: int | None = None  # allocator knob: exact cluster count
                                       # (deterministic k-center) instead of
                                       # affinity propagation's own choice
    conv_method: str = "pk"  # 'fk' | 'pk'
    prune_tol: float = 1e-8  # column-norm threshold: drop pruned inputs
    max_share_rel_err: float | None = None  # drop sharing if ||W-G[labels]||/||W|| exceeds
                                            # (paper: 'provided this has minimal impact';
                                            # the full remedy is eq.-(9) retraining)
    max_factors: int = 24
    max_terms_per_row: int = 64


@dataclass
class CompressibleDense:
    name: str
    weight: np.ndarray  # [N, K] acting as y = W x


@dataclass
class CompressibleConv:
    name: str
    kernel: np.ndarray  # [N, K, O, O]


@dataclass
class CompressedDense:
    """Everything needed to run + account one compressed dense layer."""

    name: str
    kept_columns: np.ndarray  # indices into the original K inputs
    shared: SharedLayer | None  # None if weight sharing disabled
    decomposition: LCCDecomposition
    # dense equivalent of the compressed map [N, K_kept]; None where the
    # artifact keeps no host copy (the seeded fixture at full MoE width)
    effective: np.ndarray | None

    def apply(self, x: np.ndarray) -> np.ndarray:
        """Reference evaluation: x [K_orig, ...] -> y [N, ...]."""
        xk = x[self.kept_columns]
        if self.shared is not None:
            c = self.shared.n_clusters
            agg = np.zeros((c,) + xk.shape[1:])
            np.add.at(agg, self.shared.labels, xk)
            return self.decomposition.apply(agg)
        return self.decomposition.apply(xk)


def prune_columns(w: np.ndarray, tol: float) -> tuple[np.ndarray, np.ndarray]:
    """Drop (near-)zero columns produced by the group-lasso prox.

    ``tol < 0`` selects *keep-in-place* mode: columns are not compacted (input
    addressing stays stable, so serving needs no gather layer) and the dead
    columns — norm <= |tol| — are instead eliminated per column slice by
    :func:`slice_job_plan`, which skips all-dead slices and shrinks partially
    dead ones.
    """
    if tol < 0:
        return w, np.arange(w.shape[1])
    norms = np.linalg.norm(w, axis=0)
    keep = np.where(norms > tol)[0]
    if keep.size == 0:
        keep = np.array([int(np.argmax(norms))])
    return w[:, keep], keep


@dataclass
class PreparedDense:
    """Per-unit state after the *prepare* stage (prune + cluster + slice plan).

    Everything a column-slice decomposition job needs is derived from
    ``target``/``target_snr_db`` plus config knobs, so slice jobs are pure,
    order-free and content-addressable."""

    name: str
    weight_shape: tuple[int, int]  # original [N, K] (bytes accounting only —
                                   # the full matrix is NOT retained: prepared
                                   # units are memoized across allocator probes)
    kept_columns: np.ndarray
    shared: SharedLayer | None
    target: np.ndarray  # the matrix the LCC stage decomposes
    target_snr_db: float  # resolved (+ allocator offset)
    col_slices: list[tuple[int, int]]
    baseline_adds: int
    pruned_adds: int
    pre_agg: int


def prepare_dense(name: str, w: np.ndarray, cfg: CompressionConfig) -> PreparedDense:
    """Stage 1 for a dense matrix: prune columns, cluster for weight sharing,
    resolve the fidelity target and plan the column slices."""
    w = np.asarray(w, dtype=np.float64)
    baseline = adds_csd_matrix(w, cfg.frac_bits)

    wp, kept = prune_columns(w, cfg.prune_tol)
    pruned_adds = adds_csd_matrix(wp, cfg.frac_bits)

    shared: SharedLayer | None = None
    target = wp
    pre_agg = 0
    # keep-in-place pruning (prune_tol < 0) forgoes sharing: sharing compacts
    # inputs into codebook space, which defeats stable input addressing, and
    # dead columns would distort the clustering
    if cfg.weight_sharing and wp.shape[1] > 2 and cfg.prune_tol >= 0:
        if cfg.share_clusters is not None:
            labels, cents = cluster_columns_fixed(wp, cfg.share_clusters)
        else:
            labels, cents = cluster_columns(
                wp, damping=cfg.share_damping, preference=cfg.share_preference
            )
        rel = float(np.linalg.norm(wp - cents[:, labels]) /
                    max(np.linalg.norm(wp), 1e-30))
        if cfg.max_share_rel_err is not None and rel > cfg.max_share_rel_err:
            shared = None  # too lossy without eq.-(9) retraining: skip sharing
        else:
            # store labels at their deployment width (uint16 covers any layer
            # whose kept inputs fit a 16-bit index; int32 otherwise) so byte
            # accounting below reads the true stored size, not an assumption
            # about the clustering routine's int64 output
            label_dtype = np.uint16 if cents.shape[1] <= np.iinfo(np.uint16).max else np.int32
            shared = SharedLayer(centroids=cents, labels=labels.astype(label_dtype))
            target = cents
            pre_agg = shared.pre_aggregation_adds()

    snr = resolve_target_snr_db(target, cfg.target_snr_db, cfg.frac_bits) \
        + cfg.snr_offset_db
    return PreparedDense(
        name=name, weight_shape=(int(w.shape[0]), int(w.shape[1])),
        kept_columns=kept, shared=shared, target=target,
        target_snr_db=snr,
        col_slices=plan_col_slices(target.shape[0], target.shape[1],
                                   cfg.slice_width),
        baseline_adds=baseline, pruned_adds=pruned_adds, pre_agg=pre_agg,
    )


def slice_job_plan(
    prep: PreparedDense, cfg: CompressionConfig,
) -> list[tuple[int, tuple[int, int], np.ndarray, np.ndarray | None]]:
    """The decomposition jobs a prepared dense unit actually needs.

    Returns ``(slice_index, (c0, c1), mat, keep)`` per slice that must be
    decomposed; ``keep`` is ``None`` for a full slice, else the surviving
    column offsets within the slice and ``mat`` is compacted to them.  Slices
    whose columns are *all* dead are absent — they cost 0 adds and the
    assembler drops in :func:`repro_torch.core.lcc.zero_slice_piece`.

    In drop mode (``prune_tol >= 0``) dead columns were already removed by
    :func:`prune_columns`, so every slice is a full job and nothing here
    changes — cache keys for non-sparse plans are bitwise-stable across this
    refactor.  Keep-in-place mode (``prune_tol < 0``) is where dead groups
    from regularized training become skipped/shrunk jobs.
    """
    jobs: list[tuple[int, tuple[int, int], np.ndarray, np.ndarray | None]] = []
    sparse = cfg.prune_tol < 0
    tol = abs(cfg.prune_tol)
    for i, (c0, c1) in enumerate(prep.col_slices):
        sub = prep.target[:, c0:c1]
        if not sparse:
            jobs.append((i, (c0, c1), sub, None))
            continue
        alive = np.where(np.linalg.norm(sub, axis=0) > tol)[0]
        if alive.size == 0:
            continue  # fully dead slice: skipped, 0 adds
        if alive.size == sub.shape[1]:
            jobs.append((i, (c0, c1), sub, None))
        else:
            jobs.append((i, (c0, c1), sub[:, alive], alive))
    return jobs


def finish_dense(
    prep: PreparedDense,
    pieces: list[LCCChain | FSProgram],
    cfg: CompressionConfig,
    report: ModelCostReport | None = None,
) -> CompressedDense:
    """Stage 3 for a dense matrix: assemble slice pieces (column order),
    account costs and build the dense-effective map."""
    dec = assemble_decomposition(prep.target, prep.col_slices, pieces,
                                 cfg.algorithm, prep.target_snr_db,
                                 cfg.frac_bits)
    shared, kept = prep.shared, prep.kept_columns
    if report is not None:
        lc = LayerCost(name=prep.name, baseline_adds=prep.baseline_adds)
        lc.stage_adds["pruned"] = prep.pruned_adds
        if shared is not None:
            lc.stage_adds["shared"] = shared_layer_adds(shared, cfg.frac_bits)
        lc.stage_adds["lcc"] = prep.pre_agg + dec.num_adds()
        lc.stage_bytes["dense_bf16"] = 2 * prep.weight_shape[0] * prep.weight_shape[1]
        lc.stage_bytes["lcc"] = dec.storage_bytes() + (shared.labels.nbytes if shared else 0)
        lc.extra["kept_cols"] = int(kept.size)
        lc.extra["clusters"] = int(shared.n_clusters) if shared else None
        lc.extra["achieved_snr_db"] = dec.meta.get("achieved_snr_db")
        if cfg.prune_tol < 0:
            dead = int(np.sum(np.linalg.norm(prep.target, axis=0)
                              <= abs(cfg.prune_tol)))
        else:
            dead = prep.weight_shape[1] - int(kept.size)
        lc.extra["dead_groups"] = dead
        report.add(lc)

    eff = dec.to_dense()
    if shared is not None:
        eff = eff[:, shared.labels]  # expand centroids back over kept columns
    return CompressedDense(
        name=prep.name, kept_columns=kept, shared=shared, decomposition=dec,
        effective=eff,
    )


def compress_dense_matrix(
    name: str,
    w: np.ndarray,
    cfg: CompressionConfig,
    report: ModelCostReport | None = None,
) -> CompressedDense:
    """Steps 2-3 of Algorithm 1 for one dense matrix (already reg-trained).

    Serial composition of the pipeline stages: :func:`prepare_dense` ->
    :func:`repro_torch.core.lcc.lcc_decompose_slice` per column slice ->
    :func:`finish_dense`.  ``repro_torch.pipeline`` fans the middle stage out over
    worker processes with bitwise-identical results.
    """
    prep = prepare_dense(name, w, cfg)
    n_rows = prep.target.shape[0]
    pieces: list[LCCChain | FSProgram] = [
        zero_slice_piece(cfg.algorithm, n_rows, c1 - c0)
        for c0, c1 in prep.col_slices
    ]
    for i, (c0, c1), mat, keep in slice_job_plan(prep, cfg):
        piece = lcc_decompose_slice(mat, cfg.algorithm,
                                    prep.target_snr_db, s_terms=cfg.s_terms,
                                    max_factors=cfg.max_factors,
                                    max_terms_per_row=cfg.max_terms_per_row)
        if keep is not None:
            piece = expand_slice_piece(piece, keep, c1 - c0)
        pieces[i] = piece
    return finish_dense(prep, pieces, cfg, report)


@dataclass
class PreparedConv:
    """Per-unit state after the conv *prepare* stage (FK/PK reshape + channel
    selection).  Each selected channel matrix decomposes independently — the
    pipeline's conv job granularity."""

    name: str
    kernel_shape: tuple[int, int, int, int]  # [N, K, O, O]; the kernel itself
                                             # is not retained — ``mats`` holds
                                             # the decomposition inputs
    mats: list[np.ndarray]  # per input channel, FK or PK matrix
    ch_nonzero: list[int]
    sel: list[int]  # channels actually decomposed (subsampling)
    baseline_adds: int


def prepare_conv(name: str, kernel: np.ndarray, cfg: CompressionConfig,
                 channel_subsample: int | None = None) -> PreparedConv:
    """Stage 1 for a conv kernel: reshape to per-channel matrices, drop
    group-lasso-pruned channels, pick the (sub)sampled decomposition set."""
    kernel = np.asarray(kernel, dtype=np.float64)
    n, k, o, _ = kernel.shape
    mats = conv_fk_matrices(kernel) if cfg.conv_method == "fk" else conv_pk_matrices(kernel)

    # kernel groups with all-zero rows (pruned by eq. (11) group lasso) drop
    # out; |prune_tol| so the dense keep-in-place convention (< 0) behaves —
    # conv channels decompose independently, so dropping dead ones never
    # perturbs addressing
    ch_nonzero = [i for i in range(k) if np.abs(mats[i]).max() > abs(cfg.prune_tol)]
    base_per = [adds_csd_matrix(mats[i], cfg.frac_bits) for i in range(k)]
    baseline = conv_layer_adds(base_per, n, o, cfg.conv_method, k)
    sel = ch_nonzero if channel_subsample is None else ch_nonzero[::channel_subsample]
    return PreparedConv(name=name, kernel_shape=(n, k, o, o), mats=mats,
                        ch_nonzero=ch_nonzero, sel=list(sel),
                        baseline_adds=baseline)


def conv_channel_decompose(mat: np.ndarray, cfg: CompressionConfig) -> LCCDecomposition:
    """Stage 2 for one conv input channel: decompose its FK/PK matrix.  Pure
    function of (matrix, config) — the conv job the pipeline dispatches."""
    snr = resolve_target_snr_db(mat, cfg.target_snr_db, cfg.frac_bits) \
        + cfg.snr_offset_db
    return lcc_decompose(
        mat,
        algorithm=cfg.algorithm,
        s_terms=cfg.s_terms,
        target_snr_db=snr,
        frac_bits=cfg.frac_bits,
        slice_width=cfg.slice_width,
        max_factors=cfg.max_factors,
        max_terms_per_row=cfg.max_terms_per_row,
    )


def finish_conv(
    prep: PreparedConv,
    decs: dict[int, LCCDecomposition],
    cfg: CompressionConfig,
    report: ModelCostReport | None = None,
    channel_subsample: int | None = None,
) -> dict:
    """Stage 3 for a conv kernel: per-channel adds -> layer totals + report."""
    n, k, o, _ = prep.kernel_shape
    mats, ch_nonzero, sel = prep.mats, prep.ch_nonzero, prep.sel
    lcc_per = [decs[i].num_adds() for i in sel]
    scale = (len(ch_nonzero) / max(len(sel), 1)) if sel else 0.0
    lcc_total = conv_layer_adds(
        [int(np.mean(lcc_per)) if lcc_per else 0] * len(ch_nonzero) if channel_subsample else lcc_per,
        n, o, cfg.conv_method, len(ch_nonzero),
    )
    pruned_total = conv_layer_adds(
        [adds_csd_matrix(mats[i], cfg.frac_bits) for i in ch_nonzero], n, o,
        cfg.conv_method, len(ch_nonzero),
    )
    if report is not None:
        lc = LayerCost(name=prep.name, baseline_adds=prep.baseline_adds)
        lc.stage_adds["pruned"] = pruned_total
        lc.stage_adds["lcc"] = lcc_total
        lc.extra["channels_nonzero"] = len(ch_nonzero)
        lc.extra["dead_groups"] = k - len(ch_nonzero)
        lc.extra["subsampled"] = channel_subsample
        report.add(lc)
    return {"decompositions": decs, "channels_nonzero": ch_nonzero,
            "baseline_adds": prep.baseline_adds, "lcc_adds": lcc_total,
            "scale": scale}


def compress_conv_kernel(
    name: str,
    kernel: np.ndarray,
    cfg: CompressionConfig,
    report: ModelCostReport | None = None,
    channel_subsample: int | None = None,
) -> dict:
    """Steps 2-3 for a conv layer via the FK or PK matrices.

    ``channel_subsample``: decompose only every n-th input-channel matrix and
    extrapolate the adds count (for large ResNet layers, whose channels take
    long to decompose; the decomposition of each W_k is independent so the estimate is
    unbiased). Subsampling is recorded in the report.

    Serial composition of :func:`prepare_conv` ->
    :func:`conv_channel_decompose` per channel -> :func:`finish_conv`; the
    pipeline fans the channel loop out with bitwise-identical results.
    """
    prep = prepare_conv(name, kernel, cfg, channel_subsample)
    decs = {i: conv_channel_decompose(prep.mats[i], cfg) for i in prep.sel}
    return finish_conv(prep, decs, cfg, report, channel_subsample)


def compress_model_params(
    units: list[CompressibleDense | CompressibleConv],
    cfg: CompressionConfig,
    conv_channel_subsample: int | None = None,
    progress: Callable | None = None,
    n_workers: int = 1,
    cache_dir: str | None = None,
) -> tuple[dict, ModelCostReport]:
    """Run steps 2-3 of Algorithm 1 over every compressible unit of a model.

    Thin serial wrapper over :func:`repro_torch.pipeline.run_pipeline`:
    ``n_workers > 1`` opts into the parallel pipeline with identical
    (bitwise) outputs.  ``progress`` receives structured
    :class:`repro_torch.pipeline.CompressionEvent` objects (their ``str()``
    is the unit-name line).  ``cache_dir`` makes the slice cache durable.
    """
    from repro_torch.pipeline import run_pipeline

    res = run_pipeline(units, cfg, n_workers=n_workers, cache_dir=cache_dir,
                       conv_channel_subsample=conv_channel_subsample,
                       progress=progress)
    return res.records, res.report
