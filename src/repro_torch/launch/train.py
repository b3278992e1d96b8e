"""Training launcher: ProxSGD group-lasso regularized training (the paper's
Algorithm-1 step 1), on the GPU unless ``--device cpu``.

    # olmo-1b at full width on one GPU, groups from the compression sites
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --prox \
        --batch 8 --seq 512 --steps 20

    # the paper's MLP (Sec. IV-A) on MNIST-scale stroke digits
    PYTHONPATH=src python -m repro_torch.launch.train --arch mlp --prox \
        --lambda 0.1 --epochs 12

    # the paper's full loop on the MLP: prox-regularized training ->
    # prune-aware budgeted compression -> recovery fine-tune -> fused serve
    PYTHONPATH=src python -m repro_torch.launch.train --arch mlp --prox \
        --lambda 0.1 --epochs 12 --compress-out /tmp/mlp_run --recover 60 \
        --compress-config algorithm=fp prune_tol=-1e-6 weight_sharing=false

    # rehearsal without a GPU: --device cpu also reduces the LM config
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --prox --steps 3

    # checkpoints every 10 steps (and at the end); a killed run resumes from
    # the newest intact one with the same command and --resume
    PYTHONPATH=src python -m repro_torch.launch.train --prox --steps 100 \
        --checkpoint-dir /tmp/ckpt --checkpoint-every 10 --resume

``--prox`` derives the regularized groups from the same adapter sites the
compressor slices (``training.regularize.site_group_specs``); on a GPU the
prox runs through the hand-written kernel K5 (``kernels.group_prox``), one
launch a regularized leaf a step.  The LM path trains at the constant
``--lr``, as the reference's launcher does (it builds a cosine schedule and
passes the constant to the step).  Weights are random from ``--seed``.
The LM path checkpoints the whole train state (``--checkpoint-dir``, every
``--checkpoint-every`` steps on a background writer and blocking at the
end, the last three kept); ``--resume`` restores the newest intact step and
carries on from the next, and since each batch is seeded by its step, a
resumed run sees the data an uninterrupted one would.

``--arch mlp --compress-out D`` goes on from the trained params to the
rest of the paper's loop (:func:`compress_handoff`): the compressor
(``models.api.compress_model`` with its durable slice cache under
``D/cache`` and its run manifest under ``D/run``), ``--recover N`` steps of
recovery fine-tuning (``training.recover``), the fused fc1 check (one K1
launch on a GPU) on 256 held-out samples, then the artifact under
``D/artifact`` and ``D/train_stats.json``.

``--metrics-out F`` writes the run's metrics as JSON at exit, as the
reference's launcher does: the LM path's ``train_*`` gauges and
``train_tok_s`` where it prints, the MLP's ``train_accuracy{stage}`` and
the compressor's pipeline metrics, and the process-wide registry.

The LM path trains sharded on a mesh (``--mesh 2x2``: 1-3 dims, axes
``data``, ``data x model`` or ``pod x data x model``) over ``--devices N``
ranks started here — gloo on the CPU under ``--device cpu``, NCCL over N
visible GPUs otherwise — or over the world of an enclosing ``torchrun``;
without ``--devices`` a mesh runs on one rank.  ``--grad-compression``
(int8 error-feedback all-reduce across pods) needs the pod axis;
``--elastic-demo`` drops half the ranks at step ``steps // 2`` when the
mesh has more than 2, remeshes the survivors, reshards the state from a
host copy and carries on without compression.  Rank 0 prints, checkpoints
(the state gathered to it) and writes ``--metrics-out``.  Checkpoints
belong to the LM path: ``--arch mlp`` refuses them.

    # a 2 x 2 mesh of 4 CPU ranks (gloo), then the pod axis with compression
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --devices 4 --mesh 2x2 --elastic-demo --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --devices 2 --mesh 2x1x1 --grad-compression --steps 4
"""
import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch, reduced_config
from repro_torch.data.synthetic import MarkovLM, batches
from repro_torch.kernels import dispatch
from repro_torch.obs import MetricsRegistry, dump_metrics, get_global
from repro_torch.optim.optimizers import (adamw, prox_sgd, step_decay,
                                          tree_leaves, tree_map)
from repro_torch.training import regularize

_MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def mesh_dims(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``--mesh 2x2`` -> ((2, 2), ("data", "model"))."""
    dims = tuple(int(x) for x in spec.split("x"))
    return dims, _MESH_AXES[len(dims)]


def build_mesh(spec: str | None):
    if not spec:
        return None
    from repro_torch.distributed.device_mesh import make_mesh

    return make_mesh(*mesh_dims(spec))


def _where(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _accuracy_gauge(metrics, acc: float, stage: str) -> None:
    if metrics is not None:
        metrics.gauge("train_accuracy", "held-out accuracy by stage",
                      labels=("stage",)).set(acc, stage=stage)


def train_mlp(args, device: torch.device, metrics=None):
    """--arch mlp: the training half of the paper's Sec. IV-A loop —
    (optionally prox-regularized) training on MNIST-scale stroke digits with
    the x0.95-every-3-epochs schedule, sparsity printed every third epoch,
    held-out accuracy at the end (``train_accuracy{stage="dense"}`` in
    ``metrics``).  Returns ``(stats, params, (x_test, y_test))``: the
    trained params (tensors on ``device``, detached) and the held-out set
    feed the compressor."""
    from repro_torch.data.mnist_like import train_test
    from repro_torch.models.mlp import MLPConfig, init_mlp, mlp_accuracy, mlp_loss

    batch = 128 if args.batch is None else args.batch
    lr0 = 0.08 if args.lr is None else args.lr
    cfg = MLPConfig(hidden=args.hidden)
    (xs, ys), (xte, yte) = train_test(args.train_n, args.test_n, seed=args.seed)
    xte_t = torch.from_numpy(xte).to(device)
    yte_t = torch.from_numpy(yte).to(device)
    params = init_mlp(args.seed, hidden=cfg.hidden, device=device)
    specs = regularize.site_group_specs(params, cfg, args.lam,
                                        include=args.prox_include) \
        if args.prox else ()
    opt = prox_sgd(momentum=0.9, specs=specs)
    state = opt.init(params)
    lr = step_decay(lr0, 0.95, 3)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    steps = 0
    launches0 = dispatch.launch_count("group_prox")
    t0 = time.time()
    for ep in range(args.epochs):
        for xb, yb in batches(xs, ys, batch, seed=ep):
            loss = mlp_loss(params, torch.from_numpy(xb).to(device),
                            torch.from_numpy(yb).to(device))
            it = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda _: next(it), params)
            params, state = opt.update(grads, state, params, lr(ep))
            steps += 1
        if specs and (ep % 3 == 0 or ep == args.epochs - 1):
            rep = regularize.sparsity_report(params, specs)
            print(f"epoch {ep:3d}  dead groups "
                  f"{regularize.dead_group_fraction(rep):.1%}  penalty "
                  f"{sum(float(v['penalty']) for v in rep.values()):.3f}",
                  flush=True)
    with torch.no_grad():
        acc = float(mlp_accuracy(params, xte_t, yte_t))
    _accuracy_gauge(metrics, acc, "dense")
    stats = {"arch": "mlp", "hidden": cfg.hidden, "prox": bool(args.prox),
             "lam": args.lam, "epochs": args.epochs, "batch": batch,
             "steps": steps, "train_wall_s": time.time() - t0,
             "accuracy": acc,
             "group_prox_launches": dispatch.launch_count("group_prox")
             - launches0}
    if specs:
        rep = regularize.sparsity_report(params, specs)
        stats["dead_group_fraction"] = regularize.dead_group_fraction(rep)
    print(f"train: accuracy {acc:.3f} in {stats['train_wall_s']:.1f}s, "
          f"{steps} steps on {_where(device)}"
          + (f", dead groups {stats['dead_group_fraction']:.1%}"
             if specs else "")
          + f", group_prox launches {stats['group_prox_launches']}")
    params = tree_map(lambda p: p.detach(), params)
    return stats, params, (xte_t, yte_t)


def compress_handoff(args, train_stats: dict, params, device: torch.device,
                     metrics=None) -> dict:
    """--arch mlp --compress-out: the rest of the paper's Sec. IV-A loop on
    the trained ``params``, as the reference's launcher runs it.

    1. prune-aware budgeted compression through the pipeline
       (``--compress-config``, ``--budget``, ``--workers``, ``--include``;
       dead input columns become 0-add skipped/shrunk slice jobs);
    2. ``--recover N`` steps of recovery fine-tuning of the artifact's dense
       residual (frozen chains fixed), written back into every artifact
       surface;
    3. the fused-serving check: fc1 through the packed whole-chain kernel
       on 256 held-out samples;
    4. ``art.save(<out>/artifact)`` and ``<out>/train_stats.json`` with the
       reference's keys.  Returns that stats dict.

    ``metrics`` receives the compressor's pipeline metrics and
    ``train_accuracy{stage="compressed"}``."""
    from repro_torch.data.mnist_like import train_test
    from repro_torch.launch.compress import parse_compression
    from repro_torch.models import api
    from repro_torch.models.mlp import (MLPConfig, mlp_accuracy,
                                        mlp_forward_compressed, mlp_loss)

    batch = train_stats["batch"]
    cfg = MLPConfig(hidden=args.hidden)
    (xs, ys), (xte, yte) = train_test(args.train_n, args.test_n, seed=args.seed)
    xte_t = torch.from_numpy(xte).to(device)
    yte_t = torch.from_numpy(yte).to(device)
    stats = {k: train_stats[k] for k in ("arch", "hidden", "prox", "lam",
                                         "epochs", "batch")}
    stats["train_wall_s"] = round(train_stats["train_wall_s"], 2)
    stats["accuracy"] = {"dense": train_stats["accuracy"]}
    if args.prox:
        specs = regularize.site_group_specs(params, cfg, args.lam,
                                            include=args.prox_include)
        rep = regularize.sparsity_report(params, specs)
        stats["dead_group_fraction"] = round(
            regularize.dead_group_fraction(rep), 4)
        stats["sparsity"] = {k: {kk: float(vv) for kk, vv in v.items()}
                             for k, v in rep.items()}

    compression = parse_compression(args.compress_config)
    chatty = {"plan", "skip", "unit_done", "budget", "resume"}

    def progress(ev):
        if ev.kind in chatty:
            print(f"[{ev.kind}] {ev}", flush=True)

    t0 = time.time()
    art = api.compress_model(
        params, cfg, compression, include=args.include,
        n_workers=args.workers, budget_adds=args.budget,
        cache_dir=os.path.join(args.compress_out, "cache"),
        run_dir=os.path.join(args.compress_out, "run"), progress=progress,
        metrics=metrics)
    ps = art.pipeline_stats
    stats["pipeline"] = {k: int(ps.get(k, 0)) for k in
                         ("units", "jobs", "dead_groups", "skipped_jobs",
                          "shrunk_jobs", "cache_hits", "cache_misses")}
    stats["adds"] = {"baseline": int(art.report.total_baseline()),
                     "lcc": int(art.report.total_stage("lcc"))}
    stats["compress_wall_s"] = round(time.time() - t0, 2)
    with torch.no_grad():
        acc_c = float(mlp_accuracy(art.params, xte_t, yte_t))
    stats["accuracy"]["compressed"] = acc_c
    _accuracy_gauge(metrics, acc_c, "compressed")
    print(f"compress: adds {stats['adds']['baseline']} -> "
          f"{stats['adds']['lcc']} (dead groups {ps['dead_groups']}, "
          f"skipped {ps['skipped_jobs']} jobs, shrunk {ps['shrunk_jobs']}); "
          f"accuracy {acc_c:.3f}")

    if args.recover > 0:
        from repro_torch.training.recover import recover_artifact

        def loss_fn(p, b):
            return mlp_loss(p, b[0], b[1])

        def rec_batches():
            n, ep = 0, 0
            while n < args.recover:
                for xb, yb in batches(xs, ys, batch, seed=1000 + ep):
                    if n >= args.recover:
                        return
                    yield (torch.from_numpy(xb).to(device),
                           torch.from_numpy(yb).to(device))
                    n += 1
                ep += 1

        t0 = time.time()
        res = recover_artifact(art, loss_fn, rec_batches(),
                               lr=args.recover_lr,
                               residual_frac=args.residual_frac,
                               progress=lambda m: print(f"[recover] {m}",
                                                        flush=True))
        with torch.no_grad():
            acc_r = float(mlp_accuracy(art.params, xte_t, yte_t))
        residual = sum(u.get("recover_adds", 0) for u in res["units"].values())
        stats["accuracy"]["recovered"] = acc_r
        stats["adds"]["recover_residual"] = int(residual)
        stats["adds"]["total_with_recover"] = stats["adds"]["lcc"] + int(residual)
        stats["recover"] = {"steps": len(res["losses"]),
                            "loss_first": round(res["losses"][0], 5),
                            "loss_last": round(res["losses"][-1], 5),
                            "units": res["units"],
                            "wall_s": round(time.time() - t0, 2)}
        print(f"recover: loss {stats['recover']['loss_first']:.4f} -> "
              f"{stats['recover']['loss_last']:.4f} over "
              f"{len(res['losses'])} steps; accuracy {acc_r:.3f} "
              f"(+{residual} residual adds)")

    # fused-serving check: fc1 through the packed whole-chain LCC kernel
    pk = art.packed.get("fc1")
    if pk is not None:
        with torch.no_grad():
            logits = mlp_forward_compressed(art.params, pk, xte_t[:256])
        acc_f = float((torch.argmax(logits, -1) == yte_t[:256])
                      .to(torch.float32).mean())
        stats["accuracy"]["fused"] = acc_f
        print(f"serve: fused fc1 kernel accuracy {acc_f:.3f} (256 samples)")

    art.save(os.path.join(args.compress_out, "artifact"))
    with open(os.path.join(args.compress_out, "train_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
        f.write("\n")
    print(f"artifact -> {os.path.join(args.compress_out, 'artifact')}")
    return stats


def lm_main(args, device: torch.device, metrics=None, mesh=None) -> dict:
    """The LM path; under ``mesh`` on every rank of it (rank 0 prints,
    checkpoints and returns the stats; the others return None)."""
    from repro_torch.models import api
    from repro_torch.training.trainer import (init_train_state,
                                              make_train_step,
                                              record_step_metrics)

    rank0 = mesh is None or torch.distributed.get_rank() == 0

    def say(msg: str) -> None:
        if rank0:
            print(msg, flush=True)

    batch = 8 if args.batch is None else args.batch
    lr = 3e-3 if args.lr is None else args.lr
    cfg = get_arch(args.arch)
    if args.reduced or device.type == "cpu":
        cfg = reduced_config(cfg, vocab=256)

    prox_specs = None
    if args.prox:
        prox_specs = regularize.site_group_specs(
            api.abstract_params(cfg), cfg, args.lam, include=args.prox_include)
        opt = prox_sgd(momentum=0.9, specs=prox_specs)
        say(f"[prox] {len(prox_specs)} site-derived group specs "
            f"(lambda {args.lam})")
    elif args.group_lasso > 0:
        opt = prox_sgd(momentum=0.9,
                       prox_spec={"ffn": (args.group_lasso, "columns")})
    else:
        opt = adamw(weight_decay=0.01)

    lm = MarkovLM(vocab=cfg.vocab, k=8, seed=0)
    # the residuals keep the reference's default of 2 rows, whatever the
    # mesh's pod count (its launcher never passes it)
    state = init_train_state(args.seed, cfg, opt,
                             grad_compression=args.grad_compression,
                             prox_specs=prox_specs, device=device)
    ck = (Checkpointer(args.checkpoint_dir, keep=3)
          if args.checkpoint_dir else None)
    start_step = 0
    if ck and args.resume:
        s, restored = ck.restore_latest(state)
        if s is not None:
            state, start_step = restored, s + 1
            say(f"[resume] restored checkpoint step {s}")
    if mesh is not None:
        from repro_torch.distributed.placement import gather_state, shard_state

        state = shard_state(state, mesh)

    def whole(state):
        return state if mesh is None else gather_state(state, mesh)

    def make_step(mesh):
        return make_train_step(cfg, opt, lr=lr, accum_steps=args.accum_steps,
                               grad_compression=args.grad_compression,
                               mesh=mesh, prox_specs=prox_specs)

    step_fn = make_step(mesh)
    launches0 = dispatch.launch_count("group_prox")
    t0 = time.time()
    m = {}
    for i in range(start_step, args.steps):
        b = lm.batch(batch, args.seq, seed=i)
        state, m = step_fn(state, {k: torch.from_numpy(v).to(device)
                                   for k, v in b.items()})
        if rank0 and (i % 10 == 0 or i == args.steps - 1):
            loss = float(m["loss"])  # the one host read, where it prints
            tok_s = batch * args.seq * max(i - start_step, 1) / (time.time() - t0)
            # recorded where the loop already reads the metrics to print,
            # so telemetry adds no device round trip of its own
            record_step_metrics(metrics, m, step=i)
            if metrics is not None:
                metrics.gauge("train_tok_s", "training throughput").set(tok_s)
            prox = (f"  dead {int(m['dead_groups'])}  "
                    f"pen {float(m['prox_penalty']):.2f}"
                    if "dead_groups" in m else "")
            print(f"step {i:4d}  loss {loss:.3f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  tok/s {tok_s:.0f}"
                  + prox, flush=True)
        if ck and i % args.checkpoint_every == 0 and i > start_step:
            full = whole(state)  # every rank gathers; rank 0 writes
            if rank0:
                ck.save(i, full)  # the leaves reach the host before it returns
            del full
        if (args.elastic_demo and mesh is not None and mesh.size > 2
                and i == args.steps // 2):
            mesh, state = _remesh(mesh, whole(state), say)
            if mesh is None:
                return None  # this rank was lost
            args.grad_compression = False  # single pod left
            step_fn = make_step(mesh)
    if ck:
        full = whole(state)
        if rank0:
            ck.save(args.steps - 1, full, blocking=True)
        say(f"[checkpoint] final save at step {args.steps - 1}")
    if not rank0:
        return None
    wall = time.time() - t0
    launches = dispatch.launch_count("group_prox") - launches0
    where = _where(device) + ("" if mesh is None else
                              f" x {torch.distributed.get_world_size()} ranks,"
                              f" mesh {dict(mesh.shape)}")
    print(f"done: {args.steps - start_step} steps in {wall:.1f}s on {where} "
          f"({cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}); "
          f"group_prox launches {launches}")
    return {"arch": cfg.name, "steps": args.steps - start_step,
            "start_step": start_step, "wall_s": wall,
            "loss": float(m["loss"]) if m else None,
            "group_prox_launches": launches,
            "mesh": None if mesh is None else dict(mesh.shape)}


def _remesh(mesh, full, say):
    """The elastic demo's recovery (the reference launcher's): the first
    half of the world survives (at least 2 ranks), remeshed by
    ``plan_for_devices`` with a model axis of ``min(2, n)``; the state is
    resharded from a host copy.  Every rank of the world calls it; returns
    (new mesh, this rank's chunks), or (None, None) on a rank that was
    lost."""
    from repro_torch.distributed.elastic import plan_for_devices, reshard_tree
    from repro_torch.distributed.sharding import map_tree, params_pspecs

    world = torch.distributed.get_world_size()
    survivors = list(range(world))[: max(world // 2, 2)]
    plan = plan_for_devices(len(survivors),
                            model_parallel=min(2, len(survivors)),
                            multi_pod_threshold=1 << 30)
    new_mesh = plan.build(survivors)
    say(f"[elastic] simulated pod failure; remeshing {mesh.shape} -> "
        f"{new_mesh.shape} and resharding state")
    if not new_mesh.member:
        return None, None
    device = new_mesh.device
    host = map_tree(lambda x: x.detach().cpu(), full)
    specs = params_pspecs(host, new_mesh)
    state = dataclasses.replace(reshard_tree(host, new_mesh, specs, device),
                                pspecs=specs)
    return new_mesh, state


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    help="an arch of the registry (dense, MoE, VLM, ssm "
                         "rwkv6-1.6b or hybrid zamba2-7b), or 'mlp'")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (2 layers, d_model 128, f32)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 8 (LM), 128 (mlp)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 3e-3 (LM), 0.08 (mlp)")
    ap.add_argument("--group-lasso", type=float, default=0.0,
                    help="legacy: lambda for ProxSGD on 2-D FFN leaves "
                         "(substring spec; prefer --prox)")
    ap.add_argument("--prox", action="store_true",
                    help="ProxSGD with group layouts derived from the "
                         "compression-adapter sites (paper eq. 7)")
    ap.add_argument("--lambda", dest="lam", type=float, default=0.1,
                    help="group-lasso strength for --prox")
    ap.add_argument("--prox-include", default=None,
                    help="site-name prefix filter for --prox (e.g. 'fc1')")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=12, help="mlp: train epochs")
    ap.add_argument("--hidden", type=int, default=300, help="mlp: hidden width")
    ap.add_argument("--train-n", type=int, default=4000,
                    help="mlp: training examples (mnist_like)")
    ap.add_argument("--test-n", type=int, default=1000,
                    help="mlp: held-out examples")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # --arch mlp: the full train -> compress -> recover -> serve loop
    ap.add_argument("--compress-out", default=None,
                    help="mlp: run dir; triggers the compression handoff")
    ap.add_argument("--compress-config", nargs="*", default=[],
                    metavar="KEY=VAL",
                    help="mlp: CompressionConfig overrides (launch.compress)")
    ap.add_argument("--budget", type=int, default=None,
                    help="mlp: global adds budget (allocator)")
    ap.add_argument("--workers", type=int, default=1,
                    help="mlp: pipeline worker processes")
    ap.add_argument("--include", default=None,
                    help="mlp: compression unit-name prefix filter")
    ap.add_argument("--recover", type=int, default=0,
                    help="mlp: post-compression recovery fine-tune steps")
    ap.add_argument("--recover-lr", type=float, default=2e-3)
    ap.add_argument("--residual-frac", type=float, default=0.15,
                    help="recovery residual adds budget as a fraction of the "
                         "unit's LCC adds")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="LM: save the train state here (last 3 kept)")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="LM: restore the newest intact checkpoint of "
                         "--checkpoint-dir and carry on from the next step")
    ap.add_argument("--mesh", default=None,
                    help="LM: train sharded on a mesh, e.g. 2x2 or 2x2x2 "
                         "(data / data x model / pod x data x model)")
    ap.add_argument("--devices", type=int, default=None,
                    help="LM: ranks to start for the mesh (gloo on the CPU "
                         "under --device cpu, NCCL over that many GPUs)")
    ap.add_argument("--grad-compression", action="store_true",
                    help="LM: int8 error-feedback all-reduce across pods")
    ap.add_argument("--elastic-demo", action="store_true",
                    help="simulate losing half the devices mid-run and recover")
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's metrics snapshot as JSON at exit")
    args = ap.parse_args(argv)
    if args.arch != "mlp" and args.grad_compression and (
            args.mesh is None or "pod" not in mesh_dims(args.mesh)[1]):
        raise SystemExit("--grad-compression needs a mesh with a pod axis "
                         "(e.g. 2x2x2)")
    if args.arch == "mlp" and (args.checkpoint_dir or args.resume):
        raise SystemExit("--checkpoint-dir and --resume belong to the LM "
                         "path; --arch mlp trains without checkpoints")
    return args


def _rank_main(rank: int, world: int, args) -> dict | None:
    """One rank of a meshed LM run: its device (the CPU under gloo, card
    ``rank`` under NCCL), the mesh, the run.  A rank outside the mesh has
    nothing to train and returns at once."""
    from repro_torch.distributed.device_mesh import mesh_device

    mesh = build_mesh(args.mesh)
    if not mesh.member:
        return None
    metrics = MetricsRegistry() if args.metrics_out else None
    stats = lm_main(args, mesh_device(), metrics, mesh)
    if stats is not None and args.metrics_out:
        dump_metrics(args.metrics_out, [get_global(), metrics])
        print(f"wrote {args.metrics_out}")
    return stats


def mesh_main(args) -> dict | None:
    """``--mesh``: the ranks of the run — those of an enclosing torchrun,
    ``--devices N`` spawned here, or this process alone — each through
    :func:`_rank_main`.  Returns rank 0's stats."""
    from repro_torch.distributed import device_mesh

    backend = "gloo" if args.device == "cpu" else "nccl"
    if device_mesh.in_torchrun():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device_mesh.join(rank, world, backend=backend, init_method=None,
                         device_index=int(os.environ.get("LOCAL_RANK", rank)))
        try:
            return _rank_main(rank, world, args)
        finally:
            device_mesh.leave()
    n = args.devices or 1
    if n > 1:
        threads = max(1, (os.cpu_count() or 1) // n) if backend == "gloo" else None
        return device_mesh.run_ranks(_rank_main, n, args, backend=backend,
                                     threads=threads)[0]
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        device_mesh.join(0, 1, backend=backend,
                         init_method=f"file://{os.path.join(tmp, 'store')}")
        return _rank_main(0, 1, args)
    finally:
        device_mesh.leave()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train the "
                         "reduced config on the CPU")
    if (args.device.startswith("cuda") and args.devices is not None
            and args.devices > torch.cuda.device_count()):
        raise SystemExit(f"--devices {args.devices}: only "
                         f"{torch.cuda.device_count()} CUDA device(s) visible")
    if args.arch != "mlp" and args.mesh is not None:
        return mesh_main(args)
    device = torch.device(args.device)
    metrics = MetricsRegistry() if args.metrics_out else None
    if args.arch == "mlp":
        stats, params, _ = train_mlp(args, device, metrics)
        if args.compress_out is not None:
            stats = compress_handoff(args, stats, params, device, metrics)
    else:
        stats = lm_main(args, device, metrics)
    if args.metrics_out:
        dump_metrics(args.metrics_out, [get_global(), metrics])
        print(f"wrote {args.metrics_out}")
    return stats


if __name__ == "__main__":
    main()
