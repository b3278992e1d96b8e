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


def _abstract(mesh):
    """An abstract mesh of ``mesh``'s axes and sizes (the dry run's)."""
    from repro_torch.distributed.device_mesh import AbstractMesh

    return AbstractMesh(tuple(mesh.shape.values()), tuple(mesh.shape))


def _meta(tree):
    return map_tree(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                          device="meta"), tree)


def reckoned_train(state, mesh, batch) -> dict:
    """The dry run's reckoning of one meshed train step's collectives over
    an abstract mesh of ``mesh``'s shape (nothing runs)."""
    from repro_torch.launch.dryrun import train_collectives

    am, st = _abstract(mesh), _meta(state)
    return dict(train_collectives(st, params_pspecs(st, am),
                                  _meta({k: torch.from_numpy(v)
                                         for k, v in batch.items()}),
                                  am).counts)


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
        reckoned = reckoned_train(state, mesh, inp["batches"][0])
        step = ttr.make_train_step(cfg, opt, lr=LR, prox_specs=specs, mesh=mesh)
        out[name] = _run(mesh, state, inp["batches"], step)
        out[name]["reckoned"] = reckoned
    mesh = mesh_over([0], (1, 1), ("data", "model"))
    if mesh.member:
        state = ttr.init_train_state(0, cfg, opt, prox_specs=specs,
                                     device="cpu")
        reckoned = reckoned_train(state, mesh, inp["batches"][0])
        step = ttr.make_train_step(cfg, opt, lr=LR, prox_specs=specs, mesh=mesh)
        out["1x1"] = _run(mesh, state, inp["batches"], step)
        out["1x1"]["reckoned"] = reckoned
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


# ------------------------------------------------------------ sharded serving


SERVE_MESHES = {"data": ("data", "model"), "model": ("model", "data")}
SERVE_PROMPTS = [[5, 9, 2], [7, 1], [4, 4, 4, 8], [30]]
# two prompts sharing a 20-token head (one whole 16-token block) land on
# slots 0 and 2: on different ranks of a 2-way "data" axis
SHARED_HEAD = list(range(1, 21))
SHARED_PROMPTS = [SHARED_HEAD + [3, 5], [9, 9], SHARED_HEAD + [7]]
LOGIT_TOK = [[3], [1], [2], [7]]
LOGIT_POS = [2, 1, 3, 0]


def serving_engine(case, mesh=None, kv_block=16):
    """The case's engine: 4 slots, its ``max_len``, on the CPU (paged, or
    contiguous with ``kv_block=None``)."""
    from repro_torch.serving.engine import ServingEngine

    kw = dict(n_slots=4, max_len=case["max_len"], device="cpu", mesh=mesh,
              kv_block=kv_block)
    if case.get("artifact") is not None:
        return ServingEngine(artifact=case["artifact"], **kw)
    return ServingEngine(case["params"], case["cfg"], **kw)


def serve_case(case, mesh=None, shared=True) -> dict:
    """Tokens, plan and pool stats of a generate (and of a contiguous
    cache's engine where ``case["contiguous"]``); with ``shared``, the
    shared-prefix pair's tokens and pool stats; the collectives and launches of one decode step
    (the second, all four slots live); the logits of one step at
    ``LOGIT_TOK``/``LOGIT_POS`` on a fresh state; each stored leaf's shape,
    its spec and its whole shape."""
    from repro_torch.distributed.tp import Sharded
    from repro_torch.models import api

    eng = serving_engine(case, mesh)
    out = {"tokens": [r.tokens for r in eng.generate(SERVE_PROMPTS, 6)],
           "plan_stats": eng.plan_stats(), "pool": eng.pool_stats()}
    if case.get("contiguous"):
        con = serving_engine(case, mesh, kv_block=None)
        out["contiguous"] = [r.tokens for r in con.generate(SERVE_PROMPTS, 6)]
    if shared:
        pre = serving_engine(case, mesh)
        out["shared"] = [r.tokens for r in pre.generate(SHARED_PROMPTS, 4)]
        out["shared_pool"] = pre.pool_stats()
    one = serving_engine(case, mesh)
    for p in SERVE_PROMPTS:
        one.submit(p, max_new=6)
    one.step()
    collectives.reset_collective_counts()
    one.step()
    out["step_counts"] = collectives.collective_counts()
    if mesh is not None and "cfg" in case:
        from repro_torch.launch.dryrun import decode_collectives

        out["reckoned_step"] = dict(decode_collectives(
            case["cfg"], _abstract(mesh), 4, case["max_len"])[0].counts)
    out["launches"] = one.kernel_launches_per_step
    out["logits"] = _np(serving_engine(case, mesh).decode_logits(
        torch.tensor(LOGIT_TOK), torch.tensor(LOGIT_POS)))
    if mesh is not None:
        leaves = {}

        def walk(tree, path):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, path + (k,))
            else:
                assert isinstance(tree, Sharded)
                leaves["/".join(path)] = (tuple(tree.local.shape),
                                          tuple(tree.spec), tuple(tree.shape))
        walk(eng.params, ())
        out["param_leaves"] = leaves
        cfg = eng.cfg
        whole = api.init_decode_state(cfg, 4, case["max_len"], kv_block=16,
                                      device="meta")
        out["state_leaves"] = {k: (tuple(v.shape), tuple(eng.state_specs[k]),
                                   tuple(whole[k].shape))
                               for k, v in eng.state.items()}
        out["mesh_stats"] = eng.plan_stats()["mesh"]
    return out


FAMILY_ARCHS = ("qwen2.5-3b", "mixtral-8x22b")


def family_tokens(mesh=None) -> dict:
    """The reduced qwen2.5-3b (q/k/v biases, GQA) and mixtral-8x22b (the
    experts' stacks partitioned) seeded artifacts served on the dense
    weights and on the plan route: each generate's tokens."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.testing import seeded_artifact

    out = {}
    for arch in FAMILY_ARCHS:
        art = seeded_artifact(reduced_config(get_arch(arch), vocab=64),
                              seed=1, device="cpu")
        for use_kernel in (False, True):
            eng = ServingEngine(artifact=art, n_slots=4, max_len=32,
                                use_kernel=use_kernel, device="cpu",
                                mesh=mesh)
            out[(arch, use_kernel)] = [
                r.tokens for r in eng.generate(SERVE_PROMPTS, 6)]
    return out


def sharded_serving_run(rank, world, cases):
    """At 2 ranks: every case and :func:`family_tokens` served over the
    2 x 1 meshes of ``SERVE_MESHES``; on rank 0 alone, over a 1 x 1 mesh beside the
    unsharded engine in this process (tokens and logits compared bit for
    bit here, where both run on the same threads)."""
    out = {}
    for mname, axes in SERVE_MESHES.items():
        mesh = make_mesh((2, 1), axes)
        for cname, case in cases.items():
            out[(cname, mname)] = serve_case(case, mesh)
        out[("family", mname)] = family_tokens(mesh)
    mesh = mesh_over([0], (1, 1), ("data", "model"))
    if mesh.member:
        for cname, case in cases.items():
            a = serve_case(case, mesh, shared=False)
            b = serve_case(case, shared=False)
            out[(cname, "1x1")] = dict(
                tokens=a["tokens"] == b["tokens"],
                logits=np.array_equal(a["logits"], b["logits"]),
                launches=(a["launches"], b["launches"]),
                counts=a["step_counts"],
                reckoned=a.get("reckoned_step"))
    else:
        try:
            serving_engine(cases["raw"], mesh)
        except ValueError as e:
            out["outside"] = str(e)
    return out


# ------------------------------------------------------------ moe_ffn_manual


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def moe_manual_run(rank, world, inp):
    """At 2 ranks: ``moe_ffn_manual`` on every case's mesh, inputs and
    parameters (whole on every rank); the collectives each issued; and the
    reduced mixtral artifact with ``moe_manual`` served over both 2 x 1
    meshes."""
    from repro_torch.models.moe import moe_ffn_manual

    out = {}
    for name, c in inp["cases"].items():
        mesh = make_mesh(c["dims"], ("data", "model"))
        collectives.reset_collective_counts()
        y, _ = moe_ffn_manual(_torch_tree(c["p"]), torch.from_numpy(c["x"]),
                              n_experts=c["e"], top_k=2,
                              capacity_factor=c["cf"], mesh=mesh)
        out[name] = dict(y=_np(y), counts=collectives.collective_counts())
    for mname, axes in SERVE_MESHES.items():
        eng = serving_engine(inp["serve"], make_mesh((2, 1), axes))
        out[("serve", mname)] = dict(
            tokens=[r.tokens for r in eng.generate(SERVE_PROMPTS, 6)],
            stats=eng.plan_stats(), routed=sorted(eng.executor.routed))
    return out


# ------------------------------------------- the other families under a mesh


def family_engine(case, mesh=None):
    """A case of ``tests/test_torch_sharded_families.py``: 4 slots over its
    ``max_len`` on the CPU (``bulk_prefill`` as the case says); a whisper
    engine's cross-KV placed from the case's whole one, the rank's share
    under ``state_specs`` (``placement.shard_leaf``)."""
    from repro_torch.serving.engine import ServingEngine

    kw = dict(n_slots=4, max_len=case["max_len"], device="cpu", mesh=mesh,
              bulk_prefill=case.get("bulk", True))
    eng = (ServingEngine(artifact=case["artifact"], **kw)
           if case.get("artifact") is not None
           else ServingEngine(case["params"], case["cfg"], **kw))
    for name, whole in case.get("cross", {}).items():
        whole = torch.tensor(whole, dtype=eng.state[name].dtype)
        eng.state[name].copy_(whole if mesh is None else shard_leaf(
            whole, eng.state_specs[name], mesh))
    return eng


def _leaf_table(tree, path=()) -> dict:
    from repro_torch.distributed.tp import Sharded

    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaf_table(sub, path + (key,)).items()}
    assert isinstance(tree, Sharded), path
    return {"/".join(path): (tuple(tree.local.shape), tuple(tree.spec),
                             tuple(tree.shape))}


def family_case(case, mesh=None) -> dict:
    """Tokens and errors of a generate; plan stats; on a paged engine the
    shared-prefix pair's tokens and pool stats; the launches and the
    collectives of one decode step (the second, all four slots live); the
    logits of one step at ``LOGIT_TOK``/``LOGIT_POS`` on a fresh state;
    under a mesh each stored leaf's shape, spec and whole shape."""
    from repro_torch.models import api

    eng = family_engine(case, mesh)
    res = eng.generate(SERVE_PROMPTS, 6)
    out = {"tokens": [r.tokens for r in res],
           "errors": [r.error for r in res],
           "kinds": sorted({r.stats["prefill_kind"] for r in res}),
           "plan_stats": eng.plan_stats()}
    if eng.paged:  # a shared head: MLA's tail prefill against the prefix
        pre = family_engine(case, mesh)
        out["shared"] = [r.tokens for r in pre.generate(SHARED_PROMPTS, 4)]
        out["shared_pool"] = pre.pool_stats()
    one = family_engine(case, mesh)
    for p in SERVE_PROMPTS:
        one.submit(p, max_new=6)
    one.step()
    collectives.reset_collective_counts()
    one.step()
    out["step_counts"] = collectives.collective_counts()
    out["launches"] = one.kernel_launches_per_step
    out["logits"] = _np(family_engine(case, mesh).decode_logits(
        torch.tensor(LOGIT_TOK), torch.tensor(LOGIT_POS)))
    if mesh is not None:
        from repro_torch.launch.dryrun import decode_collectives

        out["reckoned_step"] = dict(decode_collectives(
            eng.cfg, _abstract(mesh), 4, case["max_len"],
            routed=case.get("artifact") is not None)[0].counts)
        out["param_leaves"] = _leaf_table(eng.params)
        whole = api.init_decode_state(eng.cfg, 4, case["max_len"],
                                      kv_block=16 if eng.paged else None,
                                      device="meta")
        out["state_leaves"] = {
            k: (tuple(v.shape), tuple(eng.state_specs[k]),
                tuple(whole[k].shape), v.element_size())
            for k, v in eng.state.items()}
    return out


def sharded_families_run(rank, world, cases, launcher=()):
    """At 2 ranks: every case over the 2 x 1 meshes of ``SERVE_MESHES``;
    on rank 0 alone, over a 1 x 1 mesh beside the unsharded engine in this
    process (tokens and logits compared bit for bit here); each command
    line of ``launcher`` through the serve launcher's rank body on these
    ranks (rank 0's output)."""
    from repro_torch.launch import serve as serve_launch

    out = {}
    for argv in launcher:
        out[("launcher", tuple(argv))] = serve_launch._rank_main(
            rank, world, serve_launch.parse_args(argv))
    for mname, axes in SERVE_MESHES.items():
        mesh = make_mesh((2, 1), axes)
        for cname, case in cases.items():
            out[(cname, mname)] = family_case(case, mesh)
    mesh = mesh_over([0], (1, 1), ("data", "model"))
    if mesh.member:
        for cname, case in cases.items():
            a, b = family_case(case, mesh), family_case(case)
            out[(cname, "1x1")] = dict(
                tokens=a["tokens"] == b["tokens"],
                logits=np.array_equal(a["logits"], b["logits"]),
                launches=(a["launches"], b["launches"]),
                errors=a["errors"], counts=a["step_counts"],
                reckoned=a["reckoned_step"])
    return out
