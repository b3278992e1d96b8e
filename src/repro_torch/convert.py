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
from repro_torch.core.cost import LayerCost, ModelCostReport
from repro_torch.core.lcc import FSProgram, LCCChain, LCCDecomposition, LCCFactor
from repro_torch.core.weight_sharing import SharedLayer
from repro_torch.kernels.ops import PackedDecomposition, PackedStage

__all__ = ["params_from_numpy", "mlp_params_from_numpy",
           "resnet_params_from_numpy", "train_state_from_numpy",
           "artifact_from_reference", "config_from_reference",
           "conv_record_from_reference", "decomposition_from_reference",
           "packed_from_reference", "report_from_reference",
           "stage_from_reference"]


def _leaf_to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a loaded bf16 leaf
        return a.to(device=device, dtype=dtype if a.is_floating_point() else None)
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
# an MoE router (a stable top-k), rwkv6's mixes, decay, bonus and head-norm
# scale (time-mix ``mix_mu``/``w0``/``u``/``ln_w``, channel-mix ``mix_mu_k``)
# and mamba2's ``A_log``/``D``/``dt_bias``
F32_LEAVES = ("router", "mix_mu", "w0", "u", "ln_w", "mix_mu_k", "A_log", "D",
              "dt_bias")


def params_from_numpy(tree, cfg: ArchConfig, device="cuda", *,
                      _dtype: torch.dtype | None = None):
    """Nested dict/list of numpy arrays -> same nesting of tensors on
    ``device`` in ``cfg.param_dtype`` (integer leaves keep their type; bf16
    leaves may come as ``bfloat16`` arrays, as their ``uint16`` view or as
    bf16 CPU tensors, as a loaded artifact gives them).  A leaf named in
    :data:`F32_LEAVES` stays float32."""
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


def resnet_params_from_numpy(tree, cfg, device="cuda"):
    """The ResNet's parameters (``stem``, a ``blocks`` list of dicts,
    ``head``; numpy arrays) -> the same nesting of tensors on ``device`` in
    ``cfg.dtype``."""
    return params_from_numpy(tree, None, device,
                             _dtype=getattr(torch, cfg.dtype))


def train_state_from_numpy(state, cfg: ArchConfig, device="cuda"):
    """A JAX-package ``TrainState`` whose leaves are numpy arrays (the caller
    runs ``jax.tree.map(np.asarray, state)``), read by attribute -> this
    package's ``TrainState``: params in ``cfg.param_dtype`` (the
    :data:`F32_LEAVES` float32), the optimizer state (``mu``, or
    ``m``/``v``/``t``) float32 with ``t`` int32, the step, the
    gradient-compression residuals (float32 ``[n_pods, ...]``) and the
    sparsity report."""
    from repro_torch.training.trainer import TrainState

    report = getattr(state, "prox_report", None)
    efb = getattr(state, "error_fb", None)
    return TrainState(
        params=params_from_numpy(state.params, cfg, device),
        opt_state=params_from_numpy(state.opt_state, cfg, device,
                                    _dtype=torch.float32),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        error_fb=None if efb is None else params_from_numpy(
            efb, cfg, device, _dtype=torch.float32),
        prox_report=None if report is None else params_from_numpy(
            report, cfg, device, _dtype=torch.float32))


def config_from_reference(cfg):
    """An ``ArchConfig``, ``MLPConfig`` or ``ResNetConfig`` of either
    package -> this package's, field by field."""
    from repro_torch.models.mlp import MLPConfig
    from repro_torch.models.resnet import ResNetConfig

    if isinstance(cfg, (ArchConfig, MLPConfig, ResNetConfig)):
        return cfg
    if not is_dataclass(cfg):
        raise TypeError(f"cannot convert config of type {type(cfg).__name__}")
    if type(cfg).__name__ == "MLPConfig":
        return MLPConfig(**asdict(cfg))
    if type(cfg).__name__ == "ResNetConfig":
        d = asdict(cfg)
        return ResNetConfig(**{**d, "stages": tuple(d["stages"]),
                               "widths": tuple(d["widths"])})
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


def conv_record_from_reference(rec: dict) -> dict:
    """A JAX-package conv record (``compress_conv_kernel``'s dict) -> this
    package's: integer channel keys in the record's own order, each
    decomposition converted."""
    return {"decompositions": {int(ch): decomposition_from_reference(dec)
                               for ch, dec in rec["decompositions"].items()},
            "channels_nonzero": [int(c) for c in rec["channels_nonzero"]],
            "baseline_adds": int(rec["baseline_adds"]),
            "lcc_adds": int(rec["lcc_adds"]),
            "scale": float(rec["scale"])}


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


def packed_from_reference(pk) -> PackedDecomposition:
    """A JAX-package ``PackedDecomposition`` -> this package's, array for
    array (the FS dense fallbacks as float32 numpy)."""
    return PackedDecomposition(
        idx=np.asarray(pk.idx), exp=np.asarray(pk.exp),
        sign=np.asarray(pk.sign),
        col_slices=tuple(tuple(int(c) for c in cs) for cs in pk.col_slices),
        dense=tuple((tuple(int(c) for c in cs), np.asarray(w, np.float32))
                    for cs, w in pk.dense),
        in_dim=int(pk.in_dim), out_dim=int(pk.out_dim), d_pad=int(pk.d_pad),
        first_width=int(pk.first_width),
        chain_lengths=tuple(int(n) for n in pk.chain_lengths))


def report_from_reference(rep) -> ModelCostReport:
    """A JAX-package ``ModelCostReport`` -> this package's, row for row
    (values as they are)."""
    out = ModelCostReport()
    for l in rep.layers:
        out.add(LayerCost(name=l.name, baseline_adds=l.baseline_adds,
                          stage_adds=dict(l.stage_adds),
                          stage_bytes=dict(l.stage_bytes), extra=dict(l.extra)))
    return out


def artifact_from_reference(obj, device="cuda") -> CompressedModel:
    """Read a JAX-package ``CompressedModel`` by attribute into this package's
    classes: records (kept columns, shared labels/centroids, decompositions;
    conv records as :func:`conv_record_from_reference`), the packed kernel
    buffers, dense-effective params (as tensors on ``device``), the cost
    report, configs, run statistics and the layer plans the reference
    packed (``plans``, reused by the executor)."""
    from repro_torch.models.mlp import MLPConfig
    from repro_torch.models.resnet import ResNetConfig

    cfg = config_from_reference(obj.config)
    records: dict[str, CompressedDense | dict] = {}
    for name, rec in obj.records.items():
        if not hasattr(rec, "decomposition"):
            records[name] = conv_record_from_reference(rec)
            continue
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

    params = to_np(obj.params)
    if isinstance(cfg, MLPConfig):
        params = mlp_params_from_numpy(params, device)
    elif isinstance(cfg, ResNetConfig):
        params = resnet_params_from_numpy(params, cfg, device)
    else:
        params = params_from_numpy(params, cfg, device)
    return CompressedModel(
        config=cfg,
        params=params,
        records=records,
        packed={n: packed_from_reference(pk)
                for n, pk in getattr(obj, "packed", {}).items()},
        report=(None if obj.report is None
                else report_from_reference(obj.report)),
        compression=_compression_from_reference(obj.compression),
        unit_configs={n: _compression_from_reference(c)
                      for n, c in getattr(obj, "unit_configs", {}).items()},
        pipeline_stats=dict(getattr(obj, "pipeline_stats", {})),
        plans={key: {name: stage_from_reference(ps) for name, ps in st.items()}
               for key, st in getattr(obj, "plans", {}).items()})
