"""Carrying weights and artifacts across from the JAX package.

Neither ``jax`` nor ``repro`` is imported here: parameters arrive as numpy
arrays (the caller runs ``jax.tree.map(np.asarray, params)``) and a compressed
artifact is read by attribute (duck typing) into this package's own classes.
"""
from __future__ import annotations

from dataclasses import asdict, is_dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, arch_from_dict
from repro_torch.core.artifact import CompressedModel
from repro_torch.core.compress import CompressedDense, CompressionConfig
from repro_torch.core.lcc import FSProgram, LCCChain, LCCDecomposition, LCCFactor
from repro_torch.core.weight_sharing import SharedLayer
from repro_torch.kernels.ops import PackedStage

__all__ = ["params_from_numpy", "mlp_params_from_numpy",
           "train_state_from_numpy", "artifact_from_reference",
           "config_from_reference", "decomposition_from_reference",
           "stage_from_reference"]


def _leaf_to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        # bf16 crosses as its 16-bit pattern (numpy has no native bfloat16)
        bits = np.array(a, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device=device,
                                                              dtype=dtype)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.array(a, order="C")).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device=device, dtype=dtype)


# leaves that keep float32 whatever ``param_dtype`` is, as in the JAX package:
# an MoE router stays float32 for a stable top-k
F32_LEAVES = ("router",)


def params_from_numpy(tree, cfg: ArchConfig, device="cuda", *,
                      _dtype: torch.dtype | None = None):
    """Nested dict/list of numpy arrays -> same nesting of tensors on
    ``device`` in ``cfg.param_dtype`` (integer leaves keep their type; bf16
    leaves may come as ``bfloat16`` arrays or as their ``uint16`` view).  A
    ``router`` leaf stays float32."""
    dtype = cfg.pdtype if _dtype is None else _dtype
    if isinstance(tree, dict):
        return {k: params_from_numpy(
                    v, cfg, device,
                    _dtype=torch.float32 if k in F32_LEAVES else dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, cfg, device, _dtype=dtype)
                          for v in tree)
    return _leaf_to_tensor(tree, dtype, device)


def mlp_params_from_numpy(tree, device="cuda", dtype=torch.float32):
    """The paper's MLP parameters (nested dict of numpy arrays) -> tensors on
    ``device`` in ``dtype`` (the reference's ``init_mlp`` default: float32)."""
    return params_from_numpy(tree, None, device, _dtype=dtype)


def train_state_from_numpy(state, cfg: ArchConfig, device="cuda"):
    """A JAX-package ``TrainState`` whose leaves are numpy arrays (the caller
    runs ``jax.tree.map(np.asarray, state)``), read by attribute -> this
    package's ``TrainState``: params in ``cfg.param_dtype`` (a router
    float32), the optimizer state (``mu``, or ``m``/``v``/``t``) float32 with
    ``t`` int32, the step, and the sparsity report.  A state carrying
    gradient-compression residuals is refused (not ported)."""
    from repro_torch.training.trainer import TrainState

    if getattr(state, "error_fb", None) is not None:
        raise NotImplementedError("gradient-compression residuals (error_fb) "
                                  "are not available in this package yet")
    report = getattr(state, "prox_report", None)
    return TrainState(
        params=params_from_numpy(state.params, cfg, device),
        opt_state=params_from_numpy(state.opt_state, cfg, device,
                                    _dtype=torch.float32),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        prox_report=None if report is None else params_from_numpy(
            report, cfg, device, _dtype=torch.float32))


def config_from_reference(cfg) -> ArchConfig:
    """An ``ArchConfig`` of either package -> this package's, field by field."""
    if isinstance(cfg, ArchConfig):
        return cfg
    if not is_dataclass(cfg):
        raise TypeError(f"cannot convert config of type {type(cfg).__name__}")
    d = asdict(cfg)
    d["mrope_sections"] = list(d["mrope_sections"])
    return arch_from_dict(d)


def decomposition_from_reference(dec) -> LCCDecomposition:
    slices = []
    for s in dec.slices:
        if hasattr(s, "factors"):
            slices.append(LCCChain(
                factors=[LCCFactor(idx=np.asarray(f.idx, np.int32),
                                   exp=np.asarray(f.exp, np.int8),
                                   sign=np.asarray(f.sign, np.int8),
                                   in_dim=int(f.in_dim)) for f in s.factors],
                in_dim=int(s.in_dim)))
        else:  # FS program: carried as-is, evaluated through to_dense()
            slices.append(FSProgram(n_inputs=int(s.n_inputs),
                                    nodes=np.asarray(s.nodes, np.int64).reshape(-1, 6),
                                    outputs=np.asarray(s.outputs, np.int64)))
    out = LCCDecomposition(
        shape=(int(dec.shape[0]), int(dec.shape[1])),
        col_slices=[(int(a), int(b)) for a, b in dec.col_slices],
        slices=slices, algorithm=str(dec.algorithm),
        target_snr_db=float(dec.target_snr_db))
    out.meta.update({k: v for k, v in getattr(dec, "meta", {}).items()
                     if isinstance(v, (int, float, str, bool, type(None)))})
    return out


def _compression_from_reference(c) -> CompressionConfig:
    known = CompressionConfig.__dataclass_fields__
    return CompressionConfig(**{k: v for k, v in asdict(c).items() if k in known})


_STAGE_ARRAYS = ("prep_src", "prep_tgt", "gidx", "gexp", "gsgn", "outg",
                 "fs_mat", "dw_mat", "bias", "segs")


def stage_from_reference(ps) -> PackedStage:
    """A JAX-package ``PackedStage`` -> this package's, array for array."""
    arrays = {f: (None if getattr(ps, f) is None else np.asarray(getattr(ps, f)))
              for f in _STAGE_ARRAYS}
    return PackedStage(**arrays, k_alloc=int(ps.k_alloc), d_src=int(ps.d_src),
                       out_dim=int(ps.out_dim), n_layers=int(ps.n_layers),
                       site_names=tuple(ps.site_names),
                       seg_stats=ps.seg_stats, waste=ps.waste)


def artifact_from_reference(obj, device="cuda") -> CompressedModel:
    """Read a JAX-package ``CompressedModel`` by attribute into this package's
    classes: records (kept columns, shared labels/centroids, decompositions),
    dense-effective params (as tensors on ``device``), configs and the layer
    plans the reference packed (``plans``, reused by the executor).  Per-site
    kernel buffers are not carried: the executor re-packs them (bitwise the
    same)."""
    cfg = config_from_reference(obj.config)
    records: dict[str, CompressedDense] = {}
    for name, rec in obj.records.items():
        if not hasattr(rec, "decomposition"):
            raise NotImplementedError(f"unit {name!r} is not a dense record; "
                                      "conv units are not available yet")
        shared = None
        if rec.shared is not None:
            shared = SharedLayer(centroids=np.asarray(rec.shared.centroids),
                                 labels=np.asarray(rec.shared.labels, np.int64))
        records[name] = CompressedDense(
            name=name, kept_columns=np.asarray(rec.kept_columns, np.int64),
            shared=shared,
            decomposition=decomposition_from_reference(rec.decomposition),
            effective=np.asarray(rec.effective))

    def to_np(t):
        if isinstance(t, dict):
            return {k: to_np(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(to_np(v) for v in t)
        return np.asarray(t)

    return CompressedModel(
        config=cfg, params=params_from_numpy(to_np(obj.params), cfg, device),
        records=records,
        compression=_compression_from_reference(obj.compression),
        unit_configs={n: _compression_from_reference(c)
                      for n, c in getattr(obj, "unit_configs", {}).items()},
        pipeline_stats=dict(getattr(obj, "pipeline_stats", {})),
        plans={key: {name: stage_from_reference(ps) for name, ps in st.items()}
               for key, st in getattr(obj, "plans", {}).items()})
