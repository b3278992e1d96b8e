"""Paper Sec. IV-B: ResNet conv compression with FK/PK x FP/FS (Table I),
driven through the unified pipeline API (``api.compress_model`` -> the
``CompressedModel`` artifact; per-channel conv jobs fan out over workers).

Reduced pre-act ResNet on procedural textures (the ResNet-34 config itself
is exercised with sampled channels).  The artifact is served on its
dense-effective kernels (``build_packed=False``), as the reference's example
serves it.

    PYTHONPATH=src python examples/torch/resnet_compress.py [--workers 2] \\
        [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.core.artifact import CompressedModel
from repro_torch.core.compress import CompressionConfig
from repro_torch.data.synthetic import batches, textures_like
from repro_torch.models import api
from repro_torch.models.resnet import (init_resnet, resnet_forward, resnet_loss,
                                       resnet_small_config)
from repro_torch.optim.optimizers import sgd, tree_leaves, tree_map


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=2,
                    help="pipeline worker processes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    cfg = resnet_small_config(classes=6)
    xs, ys = textures_like(512, size=24, classes=6, seed=0)
    xte, yte = textures_like(128, size=24, classes=6, seed=1)
    xte_t, yte_t = torch.from_numpy(xte).to(device), torch.from_numpy(yte).to(device)
    params = init_resnet(torch.Generator().manual_seed(0), cfg, device)
    opt = sgd(momentum=0.9)
    state = opt.init(params)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    print("== training reduced pre-act ResNet on textures ==")
    for ep in range(12):
        for xb, yb in batches(xs, ys, 64, seed=ep):
            loss = resnet_loss(params, torch.from_numpy(xb).to(device),
                               torch.from_numpy(yb).to(device))
            it = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda _: next(it), params)
            params, state = opt.update(grads, state, params, 0.05)
    params = tree_map(lambda p: p.detach(), params)
    with torch.no_grad():
        logits = resnet_forward(params, xte_t)
    acc = float((torch.argmax(logits, -1) == yte_t).float().mean())
    print(f"   accuracy {acc:.3f}")

    print(f"== Table I grid: conv representation x LCC algorithm "
          f"({args.workers} workers) ==")
    print("method,alg,adds_ratio,wall_s")
    art, grid = None, []
    for conv_method in ("fk", "pk"):
        for alg in ("fp", "fs"):
            # the residual blocks only, like Table I (stem/head excluded)
            art = api.compress_model(
                params, cfg,
                CompressionConfig(algorithm=alg, conv_method=conv_method,
                                  weight_sharing=False),
                include="block", n_workers=args.workers, build_packed=False)
            print(f"{conv_method},{alg},{art.report.ratio('lcc'):.2f},"
                  f"{art.pipeline_stats['wall_s']}")
            grid.append((conv_method, alg, art.report.ratio("lcc")))

    print("== artifact round-trip: conv records + effective kernels ==")
    with tempfile.TemporaryDirectory() as d:
        art.save(d)
        art = CompressedModel.load(d, device=device)
    with torch.no_grad():
        logits_c = resnet_forward(art.params, xte_t)
    acc_c = float((torch.argmax(logits_c, -1) == yte_t).float().mean())
    print(f"   reloaded {len(art.records)} conv units; accuracy "
          f"{acc:.3f} -> {acc_c:.3f} with effective kernels")
    return {"accuracy": acc, "accuracy_effective": acc_c, "table1": grid}


if __name__ == "__main__":
    main()
