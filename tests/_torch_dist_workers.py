"""Rank-side bodies of the port's multi-process tests (each rank a spawned
process in a gloo group; see ``repro_torch.distributed.device_mesh
.run_ranks``).  This module imports only the port: the reference's side of
each comparison runs in the test process.  Results go back as numpy."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.distributed import collectives
from repro_torch.distributed.compress_grads import (compressed_psum,
                                                    init_error_state)
from repro_torch.distributed.device_mesh import make_mesh, mesh_over
from repro_torch.distributed.elastic import MeshPlan, reshard_tree
from repro_torch.distributed.overlap import overlapped_ag_matmul
from repro_torch.distributed.pipeline import gpipe_forward, split_stages
from repro_torch.distributed.placement import (gather_leaf, gather_state,
                                               gather_tree, shard_leaf,
                                               shard_state)
from repro_torch.distributed.sharding import P, map_tree, params_pspecs
from repro_torch.optim import optimizers as to
from repro_torch.training import regularize as treg
from repro_torch.training import trainer as ttr

LR = 0.05
LAM = 0.1
POD_MESHES = {4: (4, 1, 1), 2: (2, 2, 1), 1: (1, 4, 1)}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float32).numpy().copy()


def stage_fn(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def _grads(tree: dict, bf16: set, pod: int) -> dict:
    return {k: torch.from_numpy(v[pod]).to(
        torch.bfloat16 if k in bf16 else torch.float32) for k, v in tree.items()}


def collectives_run(rank, world, inp):
    """At 4 ranks: ``compressed_psum`` at 4, 2 and 1 pods over two
    error-fed rounds; GPipe at 4 stages; the overlapped all-gather matmul
    at 4 ranks; a tuple-axis shard/gather round trip; ``reshard_tree``
    from a 2 x 2 mesh to the first two ranks."""
    out = {"counts": {}}
    for n_pods, dims in POD_MESHES.items():
        mesh = make_mesh(dims, ("pod", "data", "model"))
        pod = mesh.coord("pod")
        case = inp["psum"][n_pods]
        g1 = _grads(case["g1"], case["bf16"], pod)
        g2 = _grads(case["g2"], case["bf16"], pod)
        collectives.reset_collective_counts()
        h1, e1 = compressed_psum(g1, init_error_state(g1), mesh.group("pod"))
        h2, e2 = compressed_psum(g2, e1, mesh.group("pod"))
        out["counts"][("psum", n_pods)] = collectives.collective_counts()
        out[("psum", n_pods)] = dict(
            pod=pod, dtypes={k: str(v.dtype) for k, v in h1.items()},
            **{name: {k: _np(v) for k, v in t.items()}
               for name, t in (("h1", h1), ("e1", e1), ("h2", h2), ("e2", e2))})

    mesh = make_mesh((4,), ("pipe",))
    params = split_stages({k: torch.from_numpy(v) for k, v in
                           inp["gpipe"]["params"].items()}, 4)
    collectives.reset_collective_counts()
    out["gpipe"] = _np(gpipe_forward(params, torch.from_numpy(
        inp["gpipe"]["x"]), stage_fn, mesh=mesh))
    mine = {k: v[mesh.coord("pipe"):mesh.coord("pipe") + 1]
            for k, v in params.items()}  # this stage's [1, ...] chunk alone
    out["gpipe_chunk"] = _np(gpipe_forward(mine, torch.from_numpy(
        inp["gpipe"]["x"]), stage_fn, mesh=mesh))
    out["counts"]["gpipe"] = collectives.collective_counts()

    mesh = make_mesh((4,), ("model",))
    w = torch.from_numpy(inp["overlap"]["w"])
    k = w.shape[0] // 4
    collectives.reset_collective_counts()
    out["overlap"] = _np(overlapped_ag_matmul(
        torch.from_numpy(inp["overlap"]["x"]), w[rank * k:(rank + 1) * k],
        mesh=mesh))
    out["counts"]["overlap"] = collectives.collective_counts()

    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
    x = torch.from_numpy(inp["tuple"])
    spec = P(("pod", "data"), "model")
    chunk = shard_leaf(x, spec, mesh)
    out["tuple_chunk"] = _np(chunk)
    out["tuple_back"] = _np(gather_leaf(chunk, spec, mesh))

    tree = {k: torch.from_numpy(v) for k, v in inp["tree"].items()}
    old = make_mesh((2, 2), ("data", "model"))
    chunks = reshard_tree(tree, old, params_pspecs(tree, old))
    host = map_tree(lambda t: t.cpu(), gather_tree(
        chunks, params_pspecs(tree, old), old))
    new = MeshPlan((1, 2), ("data", "model")).build(ranks=[0, 1])
    out["reshard"] = None
    if new.member:
        specs = params_pspecs(host, new)
        mine = reshard_tree(host, new, specs)
        back = gather_tree(mine, specs, new)
        out["reshard"] = dict(
            chunks={k: v.numpy().copy() for k, v in mine.items()},
            specs={k: tuple(v) for k, v in specs.items()},
            back={k: v.numpy().copy() for k, v in back.items()},
            coords=new.coords)
    return out


# ------------------------------------------------------------- train steps


def reduced_olmo():
    return reduced_config(get_arch("olmo-1b"), vocab=256)


def prox_optimizer(cfg):
    from repro_torch.models import api as tapi

    specs = treg.site_group_specs(tapi.abstract_params(cfg), cfg, LAM)
    return to.prox_sgd(0.9, specs=specs), specs


def flat_np(state) -> dict:
    """{checkpoint name: numpy array} of a whole state's leaves."""
    from repro_torch.checkpoint.checkpointer import _flatten

    return {k: v.detach().numpy().copy() for k, v in _flatten(state).items()}


def flat_specs(specs, path=()) -> dict:
    """{checkpoint name: spec tuple} of a spec tree."""
    if specs is None:
        return {}
    if isinstance(specs, P):
        return {"/".join(path): tuple(specs)}
    if isinstance(specs, dict):
        items = [(str(k), specs[k]) for k in sorted(specs)]
    elif isinstance(specs, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(specs)]
    else:
        items = [(f".{f.name}", getattr(specs, f.name))
                 for f in dataclasses.fields(specs)
                 if not f.metadata.get("static")]
    return {k: v for key, sub in items
            for k, v in flat_specs(sub, path + (key,)).items()}


def _run(mesh, state, batches, step_fn):
    """Shard ``state`` over ``mesh``, take the steps; the whole state
    gathered back, the metrics, each leaf's stored bytes and spec, and the
    collectives issued by the steps."""
    from repro_torch.checkpoint.checkpointer import _flatten

    state = shard_state(state, mesh)
    metrics = []
    collectives.reset_collective_counts()
    for b in batches:
        state, m = step_fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    counts = collectives.collective_counts()
    specs = flat_specs(state.pspecs)
    stored = {k: v.numel() * v.element_size() for k, v in _flatten(state).items()}
    return dict(state=flat_np(gather_state(state, mesh)), metrics=metrics,
                stored=stored, specs=specs, counts=counts)


def step_run(rank, world, inp):
    """At 2 ranks: the meshed step over 2 x 1 and 1 x 2 meshes and over a
    1 x 1 mesh of rank 0 from the seeded initial state; the compressed step
    at 2 pods (2 x 1 x 1) and at 1 pod (rank 0's 1 x 1 x 1) from the
    converted reference state given."""
    torch.manual_seed(0)
    cfg = reduced_olmo()
    opt, specs = prox_optimizer(cfg)
    out = {}
    for name, dims in (("2x1", (2, 1)), ("1x2", (1, 2))):
        mesh = make_mesh(dims, ("data", "model"))
        state = ttr.init_train_state(0, cfg, opt, prox_specs=specs,
                                     device="cpu")
        step = ttr.make_train_step(cfg, opt, lr=LR, prox_specs=specs, mesh=mesh)
        out[name] = _run(mesh, state, inp["batches"], step)
    mesh = mesh_over([0], (1, 1), ("data", "model"))
    if mesh.member:
        state = ttr.init_train_state(0, cfg, opt, prox_specs=specs,
                                     device="cpu")
        step = ttr.make_train_step(cfg, opt, lr=LR, prox_specs=specs, mesh=mesh)
        out["1x1"] = _run(mesh, state, inp["batches"], step)
    for name, ranks, dims in (("pods2", [0, 1], (2, 1, 1)),
                              ("pods1", [0], (1, 1, 1))):
        mesh = mesh_over(ranks, dims, ("pod", "data", "model"))
        if not mesh.member:
            continue
        step = ttr.make_train_step(cfg, opt, lr=LR, prox_specs=specs,
                                   mesh=mesh, grad_compression=True)
        out[name] = _run(mesh, inp["efb_state"], inp["batches"][:1], step)
        out[name]["pod"] = mesh.coord("pod")
    return out
