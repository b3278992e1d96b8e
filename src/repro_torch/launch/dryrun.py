"""Multi-pod dry run: every (arch x shape x mesh) cell on the ``meta``
device (counterpart of ``repro.launch.dryrun``).

There is no compiler to ask, so nothing is lowered: each cell's step runs
on the ``meta`` device over an abstract production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`), whose collectives
are entered in a ledger instead of run.  Per cell, two passes:

  1. coherence — the cell's abstract trees placed by the port's policy on
     the production mesh: the parameters (and for ``train`` the AdamW state
     as the port's optimizer holds it, the whole ``TrainState`` placed as
     the train launcher places it), the batch from ``input_specs``, for
     ``decode`` ``abstract_decode_state``.  ``prefill`` and ``decode`` then
     run the port's own meshed step on this rank's chunks
     (:class:`~repro_torch.distributed.tp.Sharded` parameters); ``train``
     gathers its state as the meshed train step does.  Yields the rank's
     ``memory.argument_bytes`` / ``output_bytes`` (each placed leaf's chunk,
     the chunk rule of :mod:`repro_torch.distributed.placement`) and the
     collectives of one step.  A spec that cannot be placed, or a step
     that cannot run there, FAILs with its error.
  2. cost — analytic, per device: ``flops`` = (``model_flops`` +
     ``attention_flops``) over the devices; ``bytes`` = the rank's argument
     and output bytes, each read once (a floor); the collectives from pass
     1 (ring accounting: a gather (n-1)/n of its output, an all-reduce
     2(n-1)/n of its tensor); the roofline against :class:`HW` (the H100's
     datasheet), every mesh axis at NVLink's rate when its group fits one
     8-card node, at the network's otherwise.

The placement a step takes is the port's: ``prefill`` and ``decode`` keep
their batch (the serving engine's slots) split over ("pod", "data") by the
serving engine's rule (``serving.engine.slot_axes``: the MoE family keeps
every sequence on every rank, its routing capacity being global), the
parameters under ``params_pspecs`` (``ws_decode``: without FSDP) and the
decode state under the engine's ``state_specs``; the decode step ends
with the engine's gather of the sampled tokens over the slot axes.  The
train step's collectives follow its spec tree (``training/trainer.py``):
one gather per named axis of every leaf of the state, then one float32
all-reduce per batch axis of every gradient and of the loss.

Cells the reference does not support SKIP with its reasons; cells whose
meshed path the port refuses today SKIP with the port's own refusal (the
serving engine's for MLA, vlm, ssm, hybrid and audio, the train step's for
``moe_manual``: ROADMAP A7c).  Fields without a counterpart are null:
``lower_s``, ``compile_s``, ``temp_bytes``, ``alias_bytes``,
``scanned_cost``, ``cost_points`` and the ``*_per_layer`` costs (no
compile, no scanned-vs-unrolled pair, no two-point extrapolation: the
reckoning is exact at the full depth).  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out dryrun_results_torch.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from dataclasses import replace

import torch

from repro_torch.configs import ARCHS, SHAPE_CELLS, cell_supported, input_specs
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import tp
from repro_torch.distributed.collectives import Ledger
from repro_torch.distributed.placement import (chunk_slices,
                                               gather_leaf, gather_tree,
                                               local_batch)
from repro_torch.distributed.sharding import (P, batch_pspecs, map_specs,
                                              map_tree, params_pspecs)
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.models import api
from repro_torch.models import flops as aflops
from repro_torch.optim.optimizers import adamw, tree_leaves
from repro_torch.training.trainer import TrainState, make_train_step

__all__ = ["apply_variant", "build_cell", "run_cell", "train_collectives",
           "decode_collectives", "main"]

DEFAULT_OUT = "dryrun_results_torch.json"
# the reference's collective kinds (HLO op names) and the port's names
_COLL = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce"}


def apply_variant(cfg: ArchConfig, variant: str | None) -> ArchConfig:
    """The reference's perf levers, selectable per run ('+'-joined)."""
    if not variant:
        return cfg
    for v in variant.split("+"):
        if v == "causal_skip":
            cfg = replace(cfg, causal_chunk_skip=True)
        elif v == "remat_off":
            cfg = replace(cfg, remat=False)
        elif v.startswith("qchunk"):
            cfg = replace(cfg, q_chunk=int(v[len("qchunk"):]))
        elif v.startswith("ssmchunk"):
            cfg = replace(cfg, ssm_chunk=int(v[len("ssmchunk"):]))
        elif v == "moe_manual":
            cfg = replace(cfg, moe_manual=True)
        elif v == "ws_decode":
            pass  # handled in build_cell (sharding, not model math)
        else:
            raise ValueError(f"unknown variant {v!r}")
    return cfg


# ----------------------------------------------------------------- placement


def _chunk(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's chunk of a meta leaf (raises where the spec cannot split
    it)."""
    return x[chunk_slices(x.shape, spec, mesh)]


def place(tree, specs, mesh):
    return map_specs(lambda x, s: _chunk(x, s, mesh), tree, specs)


def tree_bytes(tree) -> int:
    sizes = []
    map_tree(lambda t: sizes.append(t.numel() * t.element_size()), tree)
    return sum(sizes)


def _sharded(params, specs, mesh):
    return map_specs(lambda x, s: tp.Sharded(_chunk(x, s, mesh), s, mesh),
                     params, specs)


# ---------------------------------------------------------------- the steps


def train_collectives(state, specs, batch, mesh) -> Ledger:
    """The collectives of one meshed train step over ``mesh`` (an
    :class:`~repro_torch.distributed.device_mesh.AbstractMesh`): the state
    gathered from its chunks (``gather_tree``, run on them), then the
    float32 mean of every gradient and of the loss over the axes the batch
    splits over (``local_batch``), one all-reduce an axis (the rule of
    ``trainer._meshed_step``'s ``mean_over``)."""
    mesh.reset()
    whole = gather_tree(place(state, specs, mesh), specs, mesh)
    _, axes = local_batch(batch, mesh)
    ledger = mesh.reset()
    for p in tree_leaves(whole.params) + [torch.empty((), device="meta")]:
        for a in reversed(axes):
            ledger.add("all_reduce", a, mesh.shape[a], p.numel() * 4)
    return ledger


def decode_collectives(cfg: ArchConfig, mesh, n_slots: int, smax: int, *,
                       fsdp: bool = True):
    """One serving decode step of ``n_slots`` slots over ``smax`` cache
    positions, run on the meta device over ``mesh``: returns ``(ledger,
    the step's outputs)``."""
    from repro_torch.serving.engine import slot_axes, state_specs

    params = api.abstract_params(cfg)
    sp = _sharded(params, params_pspecs(params, mesh, fsdp=fsdp), mesh)
    state = api.init_decode_state(cfg, n_slots, smax, device="meta")
    bspec, _ = slot_axes(cfg, mesh, n_slots)
    st = place(state, state_specs(state, mesh, bspec), mesh)
    rows = _chunk(torch.empty((n_slots, 1), dtype=torch.int32, device="meta"),
                  P(bspec), mesh)
    pos = torch.empty((rows.shape[0],), dtype=torch.int32, device="meta")
    mesh.reset()
    logits, st = api.decode(sp, cfg, st, rows, pos, mesh=mesh)
    # the engine's step gathers its packed [3, slots] over the slot axes
    packed = torch.empty((3, rows.shape[0]), dtype=torch.int64, device="meta")
    if bspec is not None:
        packed = gather_leaf(packed, P(None, bspec), mesh)
    return mesh.reset(), (logits, st)


def build_cell(cfg: ArchConfig, cell: ShapeCell, mesh, *,
               variant: str | None = None) -> dict:
    """Pass 1 of one cell: ``{"args": bytes, "outs": bytes, "ledger":
    the collectives of one step}`` on ``mesh``, or a ``"refused"`` reason
    (the port's refusal of this cell's meshed path)."""
    from repro_torch.serving.engine import mesh_refusal

    cfg = apply_variant(cfg, variant)
    ws_decode = variant is not None and "ws_decode" in variant
    specs = input_specs(cfg, cell)
    if cell.kind == "train":
        opt = adamw()
        try:
            make_train_step(cfg, opt, mesh=mesh)
        except NotImplementedError as e:
            return {"refused": str(e)}
        params = api.abstract_params(cfg)
        state = TrainState(params=params, opt_state=opt.init(params),
                           step=torch.zeros((), dtype=torch.int32,
                                            device="meta"), error_fb=None)
        sspecs = params_pspecs(state, mesh)
        local = place(state, sspecs, mesh)
        batch = place(specs, batch_pspecs(specs, mesh), mesh)
        ledger = train_collectives(state, sspecs, specs, mesh)
        args = tree_bytes(local) + tree_bytes(batch)
        # the new state's chunks, the loss and the gradient norm
        return {"args": args, "outs": tree_bytes(local) + 2 * 4,
                "ledger": ledger}
    why = mesh_refusal(cfg)
    if why is not None:
        return {"refused": why}
    params = api.abstract_params(cfg)
    pspecs = params_pspecs(params, mesh, fsdp=not ws_decode)
    local_p = place(params, pspecs, mesh)
    if cell.kind == "prefill":
        sp = map_specs(lambda x, s: tp.Sharded(x, s, mesh), local_p, pspecs)
        # the MoE family keeps every sequence on every rank (slot_axes)
        bspecs = ({k: P() for k in specs} if cfg.moe is not None
                  else batch_pspecs(specs, mesh))
        batch = place(specs, bspecs, mesh)
        mesh.reset()
        h, _ = api.prefill(sp, cfg, batch, mesh=mesh)
        return {"args": tree_bytes(local_p) + tree_bytes(batch),
                "outs": tree_bytes(h), "ledger": mesh.reset()}
    ledger, (logits, st) = decode_collectives(
        cfg, mesh, cell.global_batch, cell.seq_len, fsdp=not ws_decode)
    tok = 2 * logits.shape[0] * 4  # the rank's token and position rows
    return {"args": tree_bytes(local_p) + tree_bytes(st) + tok,
            "outs": tree_bytes(logits) + tree_bytes(st), "ledger": ledger}


# -------------------------------------------------------------- measurement


def _axis_bw(mesh, axis: str) -> float:
    """A mesh axis's link rate: NVLink when the group holding rank 0 (ranks
    numbered row-major, the last axis fastest) fits one node, the network
    otherwise."""
    names = list(mesh.shape)
    stride = math.prod(mesh.shape[a] for a in names[names.index(axis) + 1:])
    span = (mesh.shape[axis] - 1) * stride + 1
    return HW.NVLINK_BW if span <= HW.NODE_CARDS else HW.NET_BW


def cost_snapshot(ledger: Ledger, flops: float, nbytes: float) -> dict:
    by_kind = {k: 0.0 for k in _COLL}
    counts = {k: 0 for k in _COLL}
    for op, v in ledger.link_bytes.items():
        by_kind[_KIND[op]] += v
    for op, n in ledger.counts.items():
        counts[_KIND[op]] += n
    by_kind["total"] = sum(by_kind[k] for k in _COLL)
    return {"flops": flops, "bytes": nbytes,
            "coll_link_bytes": by_kind["total"], "coll_by_kind": by_kind,
            "coll_counts": counts,
            "coll_by_axis": dict(ledger.axis_bytes),
            "flops_per_layer": None, "bytes_per_layer": None,
            "coll_link_bytes_per_layer": None}


def run_cell(arch: str, shape: str, multi_pod: bool, do_cost: bool = True,
             variant: str | None = None) -> dict:
    cfg = ARCHS[arch]
    cell = SHAPE_CELLS[shape]
    rec: dict = {"arch": arch, "shape": shape, "variant": variant or "baseline",
                 "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, why = cell_supported(cfg, cell)
    if not ok:
        rec["status"] = "SKIP"
        rec["reason"] = why
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    try:
        # pass 1: the placement and the step on the meta device
        t0 = time.perf_counter()
        built = build_cell(cfg, cell, mesh, variant=variant)
        if "refused" in built:
            rec["status"] = "SKIP"
            rec["reason"] = built["refused"]
            rec["refused_by"] = "port"
            return rec
        rec["lower_s"] = rec["compile_s"] = None
        rec["coherence_s"] = time.perf_counter() - t0
        rec["memory"] = {"argument_bytes": built["args"],
                         "output_bytes": built["outs"],
                         "temp_bytes": None, "alias_bytes": None}
        rec["scanned_cost"] = None
        rec["status"] = "PASS"
    except Exception as e:
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
        return rec

    if not do_cost:
        return rec
    vcfg = apply_variant(cfg, variant)
    mf = aflops.model_flops(vcfg, cell)
    af = aflops.attention_flops(vcfg, cell,
                                causal_skip=vcfg.causal_chunk_skip)
    full = cost_snapshot(built["ledger"], (mf + af) / n_dev,
                         float(built["args"] + built["outs"]))
    rec["cost_points"] = None
    rec["cost"] = full
    rec["roofline"] = {
        "compute_s": full["flops"] / HW.PEAK_FLOPS_BF16,
        "memory_s": full["bytes"] / HW.HBM_BW,
        "collective_s": sum(v / _axis_bw(mesh, a)
                            for a, v in full["coll_by_axis"].items()),
    }
    rec["model_flops_global"] = mf
    rec["model_flops_per_dev"] = mf / n_dev
    rec["useful_flop_ratio"] = (mf / n_dev) / max(full["flops"], 1.0)
    dom = max(rec["roofline"], key=rec["roofline"].get)
    rec["dominant"] = dom
    step_time = max(rec["roofline"].values())
    rec["roofline_fraction"] = ((mf / n_dev / HW.PEAK_FLOPS_BF16)
                                / max(step_time, 1e-12))
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="perf levers, '+'-joined: causal_skip, ws_decode, "
                         "remat_off, qchunkN, ssmchunkN, moe_manual")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPE_CELLS) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))
            for r in results}

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "2x16x16" if mp else "16x16",
                       args.variant or "baseline")
                if args.skip_existing and key in done:
                    continue
                t0 = time.time()
                rec = run_cell(arch, shape, mp, do_cost=not args.no_cost,
                               variant=args.variant)
                rec["wall_s"] = round(time.time() - t0, 1)
                results = [r for r in results if
                           (r["arch"], r["shape"], r["mesh"],
                            r.get("variant", "baseline")) != key] + [rec]
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                dom = rec.get("dominant", "-")
                print(f"[{arch} x {shape} x {key[2]}] {rec['status']} "
                      f"wall={rec['wall_s']}s dominant={dom} "
                      f"{rec.get('error', '')}", flush=True)

    n_pass = sum(r["status"] == "PASS" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    n_port = sum(r.get("refused_by") == "port" for r in results)
    print(f"\n== dry-run summary: {n_pass} PASS / {n_skip} SKIP / {n_fail} FAIL "
          f"({n_port} of the SKIPs refused by the port: ROADMAP A7c) ==")
    return results


if __name__ == "__main__":
    main()
