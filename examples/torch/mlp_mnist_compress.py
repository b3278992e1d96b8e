"""Paper Sec. IV-A end to end — the complete Algorithm-1 loop:

1. compression-aware regularized training: ProxSGD (eq. (7)/(8)) whose group
   layout is derived from the SAME adapter sites the compressor later slices,
   so regularization and compression can never disagree (the proximal step
   is the ``group_prox`` kernel on the GPU);
2. prune-aware parallel compression: exactly-zero input groups become 0-add
   skipped slice jobs, partially-dead slices shrink;
3. post-compression recovery fine-tuning: a dense residual trained on top of
   the frozen shift-add chains, written back into the artifact;
4. serving from the (saved + reloaded) ``CompressedModel`` artifact.

    PYTHONPATH=src python examples/torch/mlp_mnist_compress.py [--lam 0.1] \\
        [--epochs 12] [--workers 2] [--recover 60] [--device cpu]
"""
import argparse
import tempfile
import time

import torch

import repro_torch.core as core
from repro_torch.core.artifact import CompressedModel
from repro_torch.data.mnist_like import train_test
from repro_torch.data.synthetic import batches
from repro_torch.models import api
from repro_torch.models.mlp import MLPConfig, init_mlp, mlp_accuracy, mlp_loss
from repro_torch.optim.optimizers import prox_sgd, step_decay, tree_leaves, tree_map
from repro_torch.training import regularize
from repro_torch.training.recover import recover_artifact


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--hidden", type=int, default=300)
    ap.add_argument("--algorithm", choices=["fp", "fs"], default="fp")
    ap.add_argument("--workers", type=int, default=2,
                    help="pipeline worker processes")
    ap.add_argument("--recover", type=int, default=60,
                    help="recovery fine-tune steps (0 disables)")
    ap.add_argument("--budget", type=int, default=None,
                    help="global additions budget (allocator)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    def dev(a):
        return torch.from_numpy(a).to(device)

    print("== 1. compression-aware regularized training (ProxSGD, eq. (7)) ==")
    t0 = time.time()
    cfg = MLPConfig(hidden=args.hidden)
    (xs, ys), (xte, yte) = train_test(4000, 1000, seed=0)
    xte_t, yte_t = dev(xte), dev(yte)
    params = init_mlp(0, hidden=cfg.hidden, device=device)
    specs = regularize.site_group_specs(params, cfg, args.lam, include="fc1")
    opt = prox_sgd(momentum=0.9, specs=specs)
    state = opt.init(params)
    lr = step_decay(0.08, 0.95, 3)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    for ep in range(args.epochs):
        for xb, yb in batches(xs, ys, 128, seed=ep):
            loss = mlp_loss(params, dev(xb), dev(yb))
            it = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda _: next(it), params)
            params, state = opt.update(grads, state, params, lr(ep))
    params = tree_map(lambda p: p.detach(), params)
    acc = float(mlp_accuracy(params, xte_t, yte_t))
    rep = regularize.sparsity_report(params, specs)
    print(f"   accuracy {acc:.3f};  dead input groups "
          f"{regularize.dead_group_fraction(rep):.1%}")
    train_s = time.time() - t0

    print(f"== 2. prune-aware compression ({args.workers} workers) ==")
    comp = core.CompressionConfig(algorithm=args.algorithm,
                                  weight_sharing=False, prune_tol=-1e-6,
                                  snr_offset_db=-12.0)
    art = api.compress_model(params, cfg, comp, n_workers=args.workers,
                             budget_adds=args.budget)
    ps = art.pipeline_stats
    print(f"   adds {art.report.total_baseline()} -> "
          f"{art.report.total_stage('lcc')};  dead groups "
          f"{ps['dead_groups']}, skipped {ps['skipped_jobs']} / shrunk "
          f"{ps['shrunk_jobs']} of {ps['jobs']} slice jobs")
    acc_c = float(mlp_accuracy(art.params, xte_t, yte_t))

    acc_r = acc_c
    if args.recover:
        print(f"== 3. recovery fine-tuning ({args.recover} steps) ==")

        def loss_fn(p, b):
            return mlp_loss(p, b[0], b[1])

        def rec_batches():
            n, ep = 0, 0
            while n < args.recover:
                for xb, yb in batches(xs, ys, 128, seed=1000 + ep):
                    if n >= args.recover:
                        return
                    yield dev(xb), dev(yb)
                    n += 1
                ep += 1

        res = recover_artifact(art, loss_fn, rec_batches(), lr=2e-3)
        acc_r = float(mlp_accuracy(art.params, xte_t, yte_t))
        extra = sum(u.get("recover_adds", 0) for u in res["units"].values())
        print(f"   loss {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f};  "
              f"residual adds +{extra}")

    print("== 4. artifact round-trip: serve the recovered model from disk ==")
    with tempfile.TemporaryDirectory() as d:
        art.save(d)
        art = CompressedModel.load(d, device=device)
    acc_d = float(mlp_accuracy(art.params, xte_t, yte_t))
    print(f"== result: dense {acc:.3f} -> compressed {acc_c:.3f} -> "
          f"recovered {acc_r:.3f} (from disk {acc_d:.3f});  adds ratio "
          f"{art.report.ratio('lcc'):.2f}x ==")
    return {"accuracy": {"dense": acc, "compressed": acc_c,
                         "recovered": acc_r, "from_disk": acc_d},
            "train_s": train_s, "adds_ratio": art.report.ratio("lcc")}


if __name__ == "__main__":
    main()
