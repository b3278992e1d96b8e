"""Training launcher: ProxSGD group-lasso regularized training (the paper's
Algorithm-1 step 1), on the GPU unless ``--device cpu``.

    # olmo-1b at full width on one GPU, groups from the compression sites
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --prox \
        --batch 8 --seq 512 --steps 20

    # the paper's MLP (Sec. IV-A) on MNIST-scale stroke digits
    PYTHONPATH=src python -m repro_torch.launch.train --arch mlp --prox \
        --lambda 0.1 --epochs 12

    # rehearsal without a GPU: --device cpu also reduces the LM config
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --prox --steps 3

``--prox`` derives the regularized groups from the same adapter sites the
compressor slices (``training.regularize.site_group_specs``); on a GPU the
prox runs through the hand-written kernel K5 (``kernels.group_prox``), one
launch a regularized leaf a step.  The LM path trains at the constant
``--lr``, as the reference's launcher does (it builds a cosine schedule and
passes the constant to the step).  Weights are random from ``--seed``.

Not available yet, refused with a message: the mesh, multi-device and
gradient-compression flags and the elastic demo (the ``distributed/``
entry), checkpoints (slice 6), the MLP's compression handoff and recovery
(slice 6) and the metrics snapshot (the ``obs/`` entry).
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.data.synthetic import MarkovLM, batches
from repro_torch.kernels import dispatch
from repro_torch.optim.optimizers import (adamw, prox_sgd, step_decay,
                                          tree_leaves, tree_map)
from repro_torch.training import regularize

_QUEUE = "ROADMAP Queue A"
# flag -> (is it set?, what brings it)
_REFUSED = {
    "--mesh": (lambda a: a.mesh is not None, f"the distributed/ entry of {_QUEUE}"),
    "--devices": (lambda a: a.devices is not None,
                  f"the distributed/ entry of {_QUEUE}"),
    "--grad-compression": (lambda a: a.grad_compression,
                           f"the distributed/ entry of {_QUEUE}"),
    "--elastic-demo": (lambda a: a.elastic_demo,
                       f"the distributed/ entry of {_QUEUE}"),
    "--checkpoint-dir": (lambda a: a.checkpoint_dir is not None,
                         f"slice 6 of {_QUEUE} (checkpoints)"),
    "--resume": (lambda a: a.resume, f"slice 6 of {_QUEUE} (checkpoints)"),
    "--compress-out": (lambda a: a.compress_out is not None,
                       f"slice 6 of {_QUEUE} (the compressor handoff)"),
    "--recover": (lambda a: a.recover > 0,
                  f"slice 6 of {_QUEUE} (recovery fine-tuning)"),
    "--metrics-out": (lambda a: a.metrics_out is not None,
                      f"the obs/ entry of {_QUEUE}"),
}


def _where(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def mlp_main(args, device: torch.device) -> dict:
    """--arch mlp: the training half of the paper's Sec. IV-A loop —
    (optionally prox-regularized) training on MNIST-scale stroke digits with
    the x0.95-every-3-epochs schedule, sparsity printed every third epoch,
    held-out accuracy at the end."""
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
    return stats


def lm_main(args, device: torch.device) -> dict:
    from repro_torch.models import api
    from repro_torch.training.trainer import init_train_state, make_train_step

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
        print(f"[prox] {len(prox_specs)} site-derived group specs "
              f"(lambda {args.lam})")
    elif args.group_lasso > 0:
        opt = prox_sgd(momentum=0.9,
                       prox_spec={"ffn": (args.group_lasso, "columns")})
    else:
        opt = adamw(weight_decay=0.01)

    lm = MarkovLM(vocab=cfg.vocab, k=8, seed=0)
    state = init_train_state(args.seed, cfg, opt, prox_specs=prox_specs,
                             device=device)
    step_fn = make_train_step(cfg, opt, lr=lr, accum_steps=args.accum_steps,
                              prox_specs=prox_specs)
    launches0 = dispatch.launch_count("group_prox")
    t0 = time.time()
    m = {}
    for i in range(args.steps):
        b = lm.batch(batch, args.seq, seed=i)
        state, m = step_fn(state, {k: torch.from_numpy(v).to(device)
                                   for k, v in b.items()})
        if i % 10 == 0 or i == args.steps - 1:
            loss = float(m["loss"])  # the one host read, where it prints
            tok_s = batch * args.seq * max(i, 1) / (time.time() - t0)
            prox = (f"  dead {int(m['dead_groups'])}  "
                    f"pen {float(m['prox_penalty']):.2f}"
                    if "dead_groups" in m else "")
            print(f"step {i:4d}  loss {loss:.3f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  tok/s {tok_s:.0f}"
                  + prox, flush=True)
    wall = time.time() - t0
    launches = dispatch.launch_count("group_prox") - launches0
    print(f"done: {args.steps} steps in {wall:.1f}s on {_where(device)} "
          f"({cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}); "
          f"group_prox launches {launches}")
    return {"arch": cfg.name, "steps": args.steps, "wall_s": wall,
            "loss": float(m["loss"]) if m else None,
            "group_prox_launches": launches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    help="a dense or MoE arch of the registry, or 'mlp'")
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
    # refused: each names the slice or queue entry that brings it
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--elastic-demo", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-out", default=None)
    ap.add_argument("--recover", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)

    for flag, (is_set, where) in _REFUSED.items():
        if is_set(args):
            raise SystemExit(f"{flag} is not available in this package yet: "
                             f"it comes with {where}")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train the "
                         "reduced config on the CPU")
    device = torch.device(args.device)
    if args.arch == "mlp":
        return mlp_main(args, device)
    return lm_main(args, device)


if __name__ == "__main__":
    main()
