"""Serializable compressed-model artifact (offline compress once, serve many);
counterpart of ``repro.core.artifact``, the same files byte for byte.

A :class:`CompressedModel` bundles what the serving engine needs: per-unit
:class:`CompressedDense` records (prune indices, weight-sharing labels and
centroids, the LCC decomposition) and conv records (``finish_conv``'s dict:
one decomposition per input channel, keyed by the channel as an int, in
the order the compressor wrote them), optional pre-packed kernel buffers,
dense-effective ``params`` (a drop-in nested dict of tensors for the plain
forward and for everything not compressed), the cost report, the configs
that produced it, the pipeline's run statistics, and the layer plans an
executor packed from it.  ``models.api.compress_model`` builds one.

Persistence goes through the msgpack+crc32 :class:`Checkpointer`: the
artifact is one array tree plus a JSON manifest (itself stored as a uint8
leaf), published atomically under ``<dir>/step_<N>/``.  :meth:`load` maps the
shard read-only and walks steps newest-first, skipping a corrupted shard
with a printed warning, exactly like training restore.  Records, packed
buffers and plan stages come back as numpy arrays viewing the map
(read-only, possibly unaligned: code that would write into one must copy
first); ``params`` come back as tensors on ``device``.  A loaded plan stage
carries no ``seg_stats``/``waste`` (the reference stores neither).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any

import numpy as np

from .compress import CompressedDense, CompressionConfig
from .cost import LayerCost, ModelCostReport
from .lcc import FSProgram, LCCChain, LCCDecomposition, LCCFactor
from .weight_sharing import SharedLayer

__all__ = ["CompressedModel"]

_FORMAT_VERSION = 1
# "segs" (segment-packed layout) is optional: stages without it load with
# segs=None
_STAGE_ARRAYS = ("prep_src", "prep_tgt", "gidx", "gexp", "gsgn", "outg",
                 "fs_mat", "dw_mat", "bias", "segs")


# ---------------------------------------------------------------------------
# decomposition <-> (meta, arrays)
# ---------------------------------------------------------------------------


def _dec_to_tree(dec: LCCDecomposition) -> tuple[dict, dict]:
    meta = {
        "shape": list(dec.shape),
        "col_slices": [list(cs) for cs in dec.col_slices],
        "algorithm": dec.algorithm,
        "target_snr_db": dec.target_snr_db,
        "meta": {k: v for k, v in dec.meta.items()
                 if isinstance(v, (int, float, str, bool, type(None)))},
        "slices": [],
    }
    arrays: dict[str, Any] = {}
    for i, s in enumerate(dec.slices):
        key = f"s{i:03d}"
        if isinstance(s, LCCChain):
            meta["slices"].append({"kind": "fp", "in_dim": s.in_dim,
                                   "factor_in_dims": [f.in_dim for f in s.factors]})
            arrays[key] = {f"f{j:02d}": {"idx": f.idx, "exp": f.exp, "sign": f.sign}
                           for j, f in enumerate(s.factors)}
        else:
            meta["slices"].append({"kind": "fs", "n_inputs": s.n_inputs})
            arrays[key] = {"nodes": np.asarray(s.nodes, np.int64).reshape(-1, 6),
                           "outputs": np.asarray(s.outputs, np.int64)}
    return meta, arrays


def _dec_from_tree(meta: dict, arrays: dict) -> LCCDecomposition:
    slices: list[LCCChain | FSProgram] = []
    for i, sm in enumerate(meta["slices"]):
        tree = arrays.get(f"s{i:03d}", {})
        if sm["kind"] == "fp":
            factors = [LCCFactor(idx=np.asarray(tree[k]["idx"], np.int32),
                                 exp=np.asarray(tree[k]["exp"], np.int8),
                                 sign=np.asarray(tree[k]["sign"], np.int8),
                                 in_dim=int(sm["factor_in_dims"][j]))
                       for j, k in enumerate(sorted(tree))]
            slices.append(LCCChain(factors=factors, in_dim=int(sm["in_dim"])))
        else:
            slices.append(FSProgram(n_inputs=int(sm["n_inputs"]),
                                    nodes=np.asarray(tree["nodes"], np.int64).reshape(-1, 6),
                                    outputs=np.asarray(tree["outputs"], np.int64)))
    dec = LCCDecomposition(
        shape=tuple(meta["shape"]),
        col_slices=[tuple(cs) for cs in meta["col_slices"]],
        slices=slices,
        algorithm=meta["algorithm"],
        target_snr_db=float(meta["target_snr_db"]),
    )
    dec.meta.update(meta.get("meta", {}))
    return dec


def _conv_to_tree(rec: dict) -> tuple[dict, dict]:
    """A conv record -> (arrays under ``ch<NNNN>``, manifest entry), the
    channels in the record's own order, as the reference writes them."""
    chans, decs_meta = {}, {}
    for ch, dec in rec["decompositions"].items():
        dm, da = _dec_to_tree(dec)
        chans[f"ch{ch:04d}"] = da
        decs_meta[str(ch)] = dm
    return chans, {
        "type": "conv", "decs": decs_meta,
        "channels_nonzero": [int(c) for c in rec["channels_nonzero"]],
        "baseline_adds": int(rec["baseline_adds"]),
        "lcc_adds": int(rec["lcc_adds"]),
        "scale": float(rec["scale"]),
    }


def _conv_from_tree(um: dict, chans: dict) -> dict:
    """A conv record from its manifest entry and arrays: integer channel
    keys in the manifest's (the writer's) order — never the keys' string
    order, in which "10" comes before "2"."""
    return {"decompositions": {
                int(ch): _dec_from_tree(dm, chans.get(f"ch{int(ch):04d}", {}))
                for ch, dm in um["decs"].items()},
            "channels_nonzero": list(um["channels_nonzero"]),
            "baseline_adds": um["baseline_adds"],
            "lcc_adds": um["lcc_adds"],
            "scale": um["scale"]}


# ---------------------------------------------------------------------------
# flat-name tree reconstruction ("blocks/0/conv1" -> list index 0)
# ---------------------------------------------------------------------------


def _unflatten(flat: dict[str, Any]):
    root: dict = {}
    for name, leaf in flat.items():
        parts = name.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[k] for k in sorted(out, key=int)]
        return out

    return listify(root)


def _report_to_json(report: ModelCostReport | None) -> list[dict]:
    layers = [] if report is None else report.layers
    return [{"name": l.name, "baseline_adds": l.baseline_adds,
             "stage_adds": l.stage_adds, "stage_bytes": l.stage_bytes,
             "extra": {k: v for k, v in l.extra.items()
                       if isinstance(v, (int, float, str, bool, type(None)))}}
            for l in layers]


def _report_from_json(rows: list[dict]) -> ModelCostReport:
    rep = ModelCostReport()
    for r in rows:
        lc = LayerCost(name=r["name"], baseline_adds=int(r["baseline_adds"]))
        lc.stage_adds.update({k: int(v) for k, v in r["stage_adds"].items()})
        lc.stage_bytes.update({k: int(v) for k, v in r["stage_bytes"].items()})
        lc.extra.update(r["extra"])
        rep.add(lc)
    return rep


def _config_to_manifest(cfg) -> tuple[str, dict]:
    from repro_torch.configs.base import ArchConfig, arch_to_dict
    from repro_torch.models.mlp import MLPConfig
    from repro_torch.models.resnet import ResNetConfig

    if isinstance(cfg, ArchConfig):
        return "arch", arch_to_dict(cfg)
    if isinstance(cfg, (MLPConfig, ResNetConfig)):
        return type(cfg).__name__, asdict(cfg)
    raise TypeError(f"cannot save an artifact of config {type(cfg).__name__}")


def _config_from_manifest(kind: str, d: dict):
    from repro_torch.configs.base import arch_from_dict
    from repro_torch.models.mlp import MLPConfig
    from repro_torch.models.resnet import ResNetConfig

    if kind == "arch":
        return arch_from_dict(d)
    if kind == "ResNetConfig":
        return ResNetConfig(**{**d, "stages": tuple(d["stages"]),
                               "widths": tuple(d["widths"])})
    if kind == "MLPConfig":
        return MLPConfig(**d)
    raise ValueError(f"unknown config kind {kind!r} in artifact manifest")


def _params_on(tree, config, device):
    """Loaded ``params`` (numpy views, bf16 CPU tensors) -> tensors on
    ``device``, as ``convert`` converts a reference artifact's."""
    from repro_torch import convert
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.resnet import ResNetConfig

    if isinstance(config, ArchConfig):
        return convert.params_from_numpy(tree, config, device)
    if isinstance(config, ResNetConfig):
        return convert.resnet_params_from_numpy(tree, config, device)
    return convert.mlp_params_from_numpy(tree, device)


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------


@dataclass
class CompressedModel:
    config: Any  # ArchConfig | MLPConfig | ResNetConfig
    params: Any  # dense-effective nested dict of tensors
    records: dict[str, Any]  # unit name -> CompressedDense | conv dict
    packed: dict[str, Any] = field(default_factory=dict)  # name -> PackedDecomposition
    report: Any = None  # ModelCostReport (None for a seeded artifact)
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    unit_configs: dict[str, CompressionConfig] = field(default_factory=dict)
    pipeline_stats: dict = field(default_factory=dict)
    # layer plans: plan key ("step", "moe:l3") -> {stage name -> PackedStage};
    # packed by the executor on first use, reused by every later executor,
    # and persisted so a reload skips the packing pass
    plans: dict[str, dict] = field(default_factory=dict)

    def unit_config_for(self, name: str) -> CompressionConfig:
        return self.unit_configs.get(name, self.compression)

    @property
    def family(self) -> str:
        from repro_torch.models.api import family_of

        return family_of(self.config)

    def dense_unit_names(self) -> list[str]:
        return [n for n, r in self.records.items()
                if isinstance(r, CompressedDense)]

    # ------------------------------------------------------------------ save
    def save(self, directory: str, step: int = 0) -> None:
        """Write the artifact as step ``step`` under ``directory`` (blocking).
        ``report=None`` is saved as the empty report.  Raises ``ValueError``
        for a dense record without a host ``effective`` map (the format
        stores it)."""
        from repro_torch.checkpoint.checkpointer import Checkpointer

        units_tree: dict[str, Any] = {}
        conv_tree: dict[str, Any] = {}
        packed_tree: dict[str, Any] = {}
        man_units: dict[str, Any] = {}
        for name, rec in self.records.items():
            if not isinstance(rec, CompressedDense):
                conv_tree[name], man_units[name] = _conv_to_tree(rec)
                continue
            if rec.effective is None:
                raise ValueError(
                    f"unit {name!r} keeps no host effective map "
                    "(effective=None); the artifact format stores it, so "
                    "this artifact cannot be saved")
            dm, da = _dec_to_tree(rec.decomposition)
            t = {"kept": np.asarray(rec.kept_columns, np.int64),
                 "effective": np.asarray(rec.effective, np.float64),
                 "dec": da}
            if rec.shared is not None:
                t["labels"] = np.asarray(rec.shared.labels)
                t["centroids"] = np.asarray(rec.shared.centroids, np.float64)
            units_tree[name] = t
            man_units[name] = {"type": "dense", "dec": dm,
                               "has_shared": rec.shared is not None}
        man_packed: dict[str, Any] = {}
        for name, pk in self.packed.items():
            packed_tree[name] = {
                "idx": np.asarray(pk.idx), "exp": np.asarray(pk.exp),
                "sign": np.asarray(pk.sign),
                "dense": {f"d{i:02d}": np.asarray(w)
                          for i, ((_, _), w) in enumerate(pk.dense)},
            }
            man_packed[name] = {
                "col_slices": [list(cs) for cs in pk.col_slices],
                "dense_slices": [list(cs) for cs, _ in pk.dense],
                "in_dim": pk.in_dim, "out_dim": pk.out_dim, "d_pad": pk.d_pad,
                "first_width": pk.first_width,
                "chain_lengths": list(pk.chain_lengths),
            }
        # layer plans: arrays per (plan key, stage name), presence + static
        # ints in the manifest (an optional manifest key: format version 1)
        plans_tree: dict[str, Any] = {}
        man_plans: dict[str, Any] = {}
        for pkey, stages in self.plans.items():
            plans_tree[pkey] = {}
            man_plans[pkey] = {}
            for sname, ps in stages.items():
                arrs = {f: np.asarray(getattr(ps, f)) for f in _STAGE_ARRAYS
                        if getattr(ps, f) is not None}
                plans_tree[pkey][sname] = arrs
                man_plans[pkey][sname] = {
                    "k_alloc": ps.k_alloc, "d_src": ps.d_src,
                    "out_dim": ps.out_dim, "n_layers": ps.n_layers,
                    "site_names": list(ps.site_names),
                    "present": sorted(arrs),
                }
        kind, cfg_dict = _config_to_manifest(self.config)
        manifest = {
            "version": _FORMAT_VERSION,
            "kind": kind,
            "config": cfg_dict,
            "compression": asdict(self.compression),
            "unit_configs": {n: asdict(c) for n, c in self.unit_configs.items()},
            "pipeline_stats": self.pipeline_stats,
            "report": _report_to_json(self.report),
            "units": man_units,
            "packed": man_packed,
        }
        if man_plans:
            manifest["plans"] = man_plans
        tree = {"manifest": np.frombuffer(
                    json.dumps(manifest).encode(), np.uint8).copy(),
                "params": self.params}
        if units_tree:
            tree["units"] = units_tree
        if conv_tree:
            tree["conv"] = conv_tree
        if packed_tree:
            tree["packed"] = packed_tree
        if plans_tree:
            tree["plans"] = plans_tree
        Checkpointer(directory).save(step, tree, blocking=True)

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, directory: str, device="cuda") -> "CompressedModel":
        """The newest intact step under ``directory`` (older ones are tried
        when a shard is unreadable), ``params`` on ``device``."""
        from repro_torch.checkpoint.checkpointer import Checkpointer

        ckpt = Checkpointer(directory)
        for step in reversed(ckpt.all_steps()):
            try:
                flat = ckpt.restore_flat(step)
            except Exception as e:  # corrupted shard: fall back to older step
                print(f"[artifact] step {step} unreadable ({e}); trying older")
                continue
            return cls.from_flat(flat, device)
        raise FileNotFoundError(
            f"no intact compressed-model artifact under {directory!r}")

    @classmethod
    def from_flat(cls, flat: dict[str, Any], device="cuda") -> "CompressedModel":
        """The artifact of a crc-verified flat payload
        (``Checkpointer.restore_flat``)."""
        from repro_torch.kernels.ops import PackedDecomposition, PackedStage

        tree = _unflatten(flat)
        manifest = json.loads(np.asarray(tree.pop("manifest"),
                                         np.uint8).tobytes().decode())
        if manifest["version"] != _FORMAT_VERSION:
            raise ValueError(f"artifact format v{manifest['version']} "
                             f"!= supported v{_FORMAT_VERSION}")
        config = _config_from_manifest(manifest["kind"], manifest["config"])
        records: dict[str, Any] = {}
        for name, um in manifest["units"].items():
            if um["type"] != "dense":
                records[name] = _conv_from_tree(
                    um, tree.get("conv", {}).get(name, {}))
                continue
            t = tree["units"][name]
            shared = None
            if um["has_shared"]:
                shared = SharedLayer(centroids=np.asarray(t["centroids"]),
                                     labels=np.asarray(t["labels"]))
            records[name] = CompressedDense(
                name=name,
                kept_columns=np.asarray(t["kept"], np.int64),
                shared=shared,
                decomposition=_dec_from_tree(um["dec"], t.get("dec", {})),
                effective=np.asarray(t["effective"], np.float64),
            )
        packed: dict[str, Any] = {}
        for name, pm in manifest.get("packed", {}).items():
            t = tree.get("packed", {}).get(name, {})
            dense_arrs = t.get("dense", {})
            dense = tuple(
                (tuple(cs), np.asarray(dense_arrs[f"d{i:02d}"], np.float32))
                for i, cs in enumerate(pm["dense_slices"]))
            packed[name] = PackedDecomposition(
                idx=np.asarray(t["idx"], np.int32),
                exp=np.asarray(t["exp"], np.int8),
                sign=np.asarray(t["sign"], np.int8),
                col_slices=tuple(tuple(cs) for cs in pm["col_slices"]),
                dense=dense,
                in_dim=int(pm["in_dim"]), out_dim=int(pm["out_dim"]),
                d_pad=int(pm["d_pad"]), first_width=int(pm["first_width"]),
                chain_lengths=tuple(pm["chain_lengths"]),
            )
        plans: dict[str, dict] = {}
        for pkey, pstages in manifest.get("plans", {}).items():
            stages = {}
            for sname, sm in pstages.items():
                arrs = tree.get("plans", {}).get(pkey, {}).get(sname, {})
                kw = {f: (np.asarray(arrs[f]) if f in sm["present"] else None)
                      for f in _STAGE_ARRAYS}
                stages[sname] = PackedStage(
                    k_alloc=int(sm["k_alloc"]), d_src=int(sm["d_src"]),
                    out_dim=int(sm["out_dim"]), n_layers=int(sm["n_layers"]),
                    site_names=tuple(sm["site_names"]), **kw)
            plans[pkey] = stages
        comp = CompressionConfig(**manifest["compression"])
        unit_configs = {n: CompressionConfig(**d)
                        for n, d in manifest.get("unit_configs", {}).items()}
        return cls(config=config,
                   params=_params_on(tree["params"], config, device),
                   records=records, packed=packed,
                   report=_report_from_json(manifest["report"]),
                   compression=comp, unit_configs=unit_configs,
                   pipeline_stats=manifest.get("pipeline_stats", {}),
                   plans=plans)
