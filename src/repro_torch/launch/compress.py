"""Offline compression launcher: parallel, resumable, budget-driven Algorithm 1
(counterpart of ``repro.launch.compress``).

    # quickstart-scale dense transformer, 4 worker processes
    PYTHONPATH=src python -m repro_torch.launch.compress --arch olmo-1b \
        --quickstart --workers 4 --out /tmp/comp

    # budget-constrained run (adds-budget allocator chooses per-unit plans),
    # resumable after a kill: same command + --resume picks up the cached
    # slices and the recorded plans
    PYTHONPATH=src python -m repro_torch.launch.compress --arch olmo-1b \
        --quickstart --budget 200000 --workers 4 --out /tmp/comp --resume

    # without a GPU: --device cpu (implies --quickstart)
    PYTHONPATH=src python -m repro_torch.launch.compress --device cpu \
        --workers 2 --out /tmp/comp

    # the reduced ResNet's conv units (FK/PK per --config conv_method=...)
    PYTHONPATH=src python -m repro_torch.launch.compress --arch resnet-small \
        --device cpu --workers 2 --out /tmp/comp_resnet

The run directory layout under ``--out``:

    run/          pipeline manifest (chosen per-unit plans, unit hashes)
    cache/        content-addressed slice results (msgpack+crc32)
    artifact/     the final ``CompressedModel`` checkpoint
    stats.json    the pipeline's run statistics

The artifact is what ``ServingEngine(artifact=CompressedModel.load(...))``
serves, and the reference's ``CompressedModel.load`` reads it too.  The
decomposition runs on the host (numpy, worker processes); the parameters
live on ``--device``.  ``--metrics-out F`` writes the run's metrics
(the pipeline's events and run stats, ``pipeline_adds{stage}`` and the
process-wide registry) as JSON at exit, as the reference's launcher does.
"""
import argparse
import json
import os
import time

import torch

from repro_torch.core import CompressionConfig


def build_model(arch: str, quickstart: bool, seed: int, device):
    """(params, cfg) for a registry arch, the paper's MLP or the reduced
    ResNet (6 classes, as the reference's), parameters on ``device``.

    Parameters are keyed by ``--seed`` so repeated invocations (and the
    resume path) see identical weights; point this at a training checkpoint
    restore for real runs.  They come from this package's initialisers
    (numpy generators seeded by ``seed``; the ResNet's a
    ``torch.Generator``): ``jax.random`` streams cannot be
    reproduced here, so the same seed gives other weights than the
    reference launcher's.
    """
    if arch == "resnet-small":
        from repro_torch.models.resnet import init_resnet, resnet_small_config

        cfg = resnet_small_config(classes=6)
        return init_resnet(torch.Generator().manual_seed(seed), cfg,
                           device), cfg
    if arch == "mlp":
        from repro_torch.models.mlp import MLPConfig, init_mlp

        cfg = MLPConfig()
        return init_mlp(seed, in_dim=cfg.in_dim, hidden=cfg.hidden,
                        classes=cfg.classes, device=device), cfg
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.models import api

    cfg = get_arch(arch)
    if quickstart:
        cfg = reduced_config(cfg, vocab=64, n_layers=2, d_model=32, d_ff=48,
                             n_heads=2, n_kv_heads=2, head_dim=16)
    return api.init_params(seed, cfg, device), cfg


def parse_compression(pairs: list[str]) -> CompressionConfig:
    """--config key=value overrides onto the pipeline's default FP config."""
    cfg = CompressionConfig(algorithm="fp", weight_sharing=True,
                            max_share_rel_err=0.06)
    for pair in pairs:
        key, _, val = pair.partition("=")
        if not hasattr(cfg, key):
            raise SystemExit(f"unknown CompressionConfig field {key!r}")
        cur = getattr(cfg, key)
        if val.lower() in ("none", "null"):
            parsed = None
        elif isinstance(cur, bool):
            parsed = val.lower() in ("1", "true", "yes")
        elif isinstance(cur, int) and not isinstance(cur, bool):
            parsed = int(val)
        elif isinstance(cur, float):
            parsed = float(val)
        elif cur is None:  # untyped optionals: frac-ish => float, else int
            parsed = float(val) if "." in val else int(val)
        else:
            parsed = val
        setattr(cfg, key, parsed)
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b",
                    help="registry arch id, 'mlp' or 'resnet-small'")
    ap.add_argument("--family", default=None,
                    help="expected architecture family (sanity check)")
    ap.add_argument("--quickstart", action="store_true",
                    help="reduced quickstart-scale dims (implied by --device cpu)")
    ap.add_argument("--config", nargs="*", default=[], metavar="KEY=VAL",
                    help="CompressionConfig overrides, e.g. algorithm=fs")
    ap.add_argument("--budget", type=int, default=None,
                    help="global additions budget (invokes the allocator)")
    ap.add_argument("--workers", type=int, default=1,
                    help="slice-job worker processes")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed run from --out (manifest + cache)")
    ap.add_argument("--out", required=True, help="run directory")
    ap.add_argument("--include", default=None,
                    help="unit-name prefix filter, e.g. 'ffn.'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conv-subsample", type=int, default=None)
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-slice progress events")
    ap.add_argument("--device", default="cuda",
                    help="where the parameters live; 'cpu' also implies "
                         "--quickstart")
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's metrics snapshot as JSON at exit")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to compress the "
                         "quickstart config on the CPU")
    from repro_torch.models import api
    from repro_torch.obs import MetricsRegistry, dump_metrics, get_global
    from repro_torch.pipeline import runner

    metrics = MetricsRegistry() if args.metrics_out else None
    params, cfg = build_model(args.arch,
                              args.quickstart or args.device == "cpu",
                              args.seed, torch.device(args.device))
    family = api.family_of(cfg)
    if args.family is not None and args.family != family:
        raise SystemExit(f"--family {args.family} but {args.arch} is {family!r}")
    compression = parse_compression(args.config)

    chatty = {"plan", "unit_done", "budget", "resume"}

    def progress(ev):
        if not args.quiet or ev.kind in chatty:
            print(f"[{ev.kind}] {ev}", flush=True)

    t0 = time.time()
    art = api.compress_model(
        params, cfg, compression,
        include=args.include,
        conv_channel_subsample=args.conv_subsample,
        n_workers=args.workers,
        budget_adds=args.budget,
        cache_dir=os.path.join(args.out, "cache"),
        run_dir=os.path.join(args.out, "run"),
        resume=args.resume,
        progress=progress,
        metrics=metrics,
    )
    art.save(os.path.join(args.out, "artifact"))
    wall = time.time() - t0

    stats = dict(art.pipeline_stats)
    stats["total_wall_s"] = round(wall, 2)
    print(art.report.table())
    lcc = art.report.total_stage("lcc")
    print(f"family={family} units={stats['units']} jobs={stats['jobs']} "
          f"workers={stats['workers']} cache={stats['cache_hits']}h/"
          f"{stats['cache_misses']}m wall={wall:.1f}s "
          f"({stats['units_per_s']} units/s)")
    print(f"adds: baseline {art.report.total_baseline()} -> lcc {lcc} "
          f"(ratio {art.report.ratio('lcc'):.2f}x)"
          + (f"; budget {args.budget} landed {lcc / args.budget:.1%}"
             if args.budget else ""))
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
        f.write("\n")
    if args.metrics_out:
        adds = metrics.gauge("pipeline_adds", "artifact adds by stage",
                             labels=("stage",))
        adds.set(art.report.total_baseline(), stage="baseline")
        adds.set(lcc, stage="lcc")
        dump_metrics(args.metrics_out, [get_global(), metrics])
        print(f"wrote {args.metrics_out}")
    print(f"artifact -> {os.path.join(args.out, 'artifact')}")
    runner.shutdown_workers(wait=True)  # the pool's processes end with the run
    return stats


if __name__ == "__main__":  # worker processes import this module
    main()
