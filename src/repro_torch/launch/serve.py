"""Serving launcher: scheduler-driven batched generation from a compressed
artifact, on the GPU unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --kernel

    # Algorithm 1 over every compressible site first, then serve the result
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --compress --kernel

    # small widths, e.g. to rehearse on a machine without a GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --requests 3 --max-new 8 --kernel

    # the recurrent families (tokenwise prefill, the per-region route)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --reduced --device cpu --kernel

    # the encoder-decoder (whisper-small): tokenwise prefill, per-region,
    # the cross-KV left at zero (the engine's caller owns it)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --reduced --device cpu --kernel

Paged engines share prefilled prompt-prefix blocks across requests by
default (``--no-prefix-cache`` turns it off); the end-of-run line reports
the prefix hit rate and the copy-on-write copies.

``--compress`` runs the compressor (``api.compress_model``, Algorithm 1)
over every compressible site of ``api.init_params(--seed)`` under the
reference launcher's config — FP with ``--kernel`` (packed for the fused
kernels), FS without — prints the cost report and serves the artifact.
Every rank of a ``--dp``/``--tp`` mesh compresses the same parameters (the
compressor is deterministic).  It takes seconds at ``--reduced`` widths and
hours at published ones (about 3.35 CPU-hours a layer of olmo-1b).

Without ``--compress`` the artifact comes from the seeded fixture
(``repro_torch.testing.seeded_artifact``): valid LCC chains at the model's
width, random weights; ``--kernel`` serves it through the fused kernels,
which the reference refuses without ``--compress`` (ROADMAP Queue C,
"Divergences by design").  An artifact the offline compressor
(``repro_torch.launch.compress``) wrote is served with
``ServingEngine(artifact=CompressedModel.load(dir))``.  A whisper engine's
cross-KV (``state["cross_k"/"cross_v"]``, the encoder's states through each
decoder layer's ``xattn.k/v``) is its caller's to fill per slot
(``testing.fill_cross_kv``); this launcher, as the reference's, leaves it
at zero.

Telemetry, as in the reference: the engine traces every request
(``tracer=True``) and the end-of-run summary prints queue wait, TTFT, TPOT
and end-to-end p50/p99, the profiler's decode steps and tok/s, and the live
roofline when the artifact carries a cost report (the seeded fixture has
none; ``--compress``'s has one).  ``--metrics-out F`` writes the merged metrics (the engine's and the
process-wide registry) with the trace summary, the profiler summary and
the live roofline as JSON; ``--trace-out G`` one span a request as JSONL;
``--metrics-port P`` serves ``GET /metrics`` (Prometheus text) on
127.0.0.1 for the run (0 picks a free port; its URL is printed).

``--dp D --tp T`` serves over a ("data", "model") mesh of D x T ranks
(1 x 1 is no mesh, as in the reference): the ranks of an enclosing
``torchrun``, or D x T ranks started here — gloo on the CPU under ``--device
cpu``, NCCL over the visible GPUs (one rank a card).  Every rank builds the
same artifact and serves the same requests (``ServingEngine(mesh=)``); rank
0 prints the lines below, its ``where`` field ``mesh DxT``, and writes the
telemetry files.

    # 4 gloo ranks on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --dp 2 --tp 2
"""
import argparse
import contextlib
import io
import os
import time
from dataclasses import replace

import torch

from repro_torch import obs
from repro_torch.configs import get_arch, reduced_config
from repro_torch.core.compress import CompressionConfig
from repro_torch.data.synthetic import MarkovLM
from repro_torch.models import api
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.testing import seeded_artifact


def compressed_artifact(params, cfg, kernel: bool):
    """Algorithm 1 over every compressible site of ``params`` under the
    reference launcher's config: FP packed for the fused kernels with
    ``kernel``, FS (dense-effective weights only) without."""
    return api.compress_model(
        params, cfg,
        CompressionConfig(algorithm="fp" if kernel else "fs",
                          max_share_rel_err=0.06),
        build_packed=kernel)


def build_mesh(dp: int, tp: int):
    """A ("data", "model") mesh of ``dp`` x ``tp`` ranks of this process's
    group, or None for 1 x 1."""
    if dp * tp <= 1:
        return None
    from repro_torch.distributed.device_mesh import make_mesh

    return make_mesh((dp, tp), ("data", "model"))


def main(argv=None) -> ServingEngine | None:
    """The launcher; returns the engine it served with (None over a mesh,
    whose engines live in their ranks)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (2 layers, d_model 128, f32)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (width is never cut)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--compress", action="store_true",
                    help="Algorithm 1 over every compressible site (any "
                         "family) of the seeded parameters, served from the "
                         "CompressedModel artifact (without it: the seeded "
                         "fixture)")
    ap.add_argument("--kernel", action="store_true",
                    help="decode through the site-keyed fused-kernel executor "
                         "(the whole-step layer plan for float32 configs, the "
                         "per-region route otherwise; CUDA kernels on a GPU, "
                         "their plain versions on --device cpu); without it "
                         "decode uses the artifact's dense-effective weights")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are sampled")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="paged-KV block size in tokens; 0 = contiguous "
                         "per-slot slabs")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="total usable KV pool blocks (default: one full "
                         "view per slot)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share prefilled prompt-prefix blocks across "
                         "requests (copy-on-write; paged engines only)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the merged metrics snapshot (+ trace summary "
                         "and live roofline) as JSON at exit")
    ap.add_argument("--trace-out", default=None,
                    help="write per-request spans as JSONL at exit")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve GET /metrics (Prometheus text) on this port "
                         "for the run's duration (0 = ephemeral)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel mesh axis")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel mesh axis")
    args = ap.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "versions on the CPU")
    n = args.dp * args.tp
    if n > 1:
        if args.device.startswith("cuda") and n > torch.cuda.device_count():
            raise SystemExit(f"--dp {args.dp} x --tp {args.tp} needs {n} "
                             f"GPUs, {torch.cuda.device_count()} visible")
        print(mesh_main(args), end="")
        return None
    return serve(args, torch.device(args.device))


def _rank_main(rank: int, world: int, args) -> str | None:
    """One rank of a meshed serve: its mesh, its engine, the run; returns
    what rank 0 printed (the other ranks print nothing and write no
    telemetry file).  A rank outside the mesh returns at once."""
    from repro_torch.distributed.device_mesh import mesh_device

    mesh = build_mesh(args.dp, args.tp)
    if not mesh.member:
        return None
    if rank != 0:
        args = argparse.Namespace(**{**vars(args), "metrics_out": None,
                                     "trace_out": None, "metrics_port": None})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve(args, mesh_device(), mesh)
    return out.getvalue() if rank == 0 else None


def mesh_main(args) -> str:
    """``--dp``/``--tp``: the ranks of an enclosing torchrun, or D x T ranks
    started here, each through :func:`_rank_main`.  Returns rank 0's
    output (empty on the other ranks of a torchrun)."""
    from repro_torch.distributed import device_mesh

    backend = "gloo" if args.device == "cpu" else "nccl"
    n = args.dp * args.tp
    if device_mesh.in_torchrun():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device_mesh.join(rank, world, backend=backend, init_method=None,
                         device_index=int(os.environ.get("LOCAL_RANK", rank)))
        try:
            return _rank_main(rank, world, args) or ""
        finally:
            device_mesh.leave()
    threads = max(1, (os.cpu_count() or 1) // n) if backend == "gloo" else None
    return device_mesh.run_ranks(_rank_main, n, args, backend=backend,
                                 threads=threads)[0]


def serve(args, device: torch.device, mesh=None) -> ServingEngine:
    """Build the artifact (compressed with ``--compress``, else the seeded
    fixture) and its engine (over ``mesh`` when given), serve the
    launcher's requests; returns the engine."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, vocab=256)
    if args.layers is not None:
        cfg = replace(cfg, n_layers=args.layers)
    t0 = time.time()
    if args.compress:
        params = api.init_params(args.seed, cfg, device)
        artifact = compressed_artifact(params, cfg, args.kernel)
        del params
        print(artifact.report.table())
        what = "compressed artifact"
    else:
        artifact = seeded_artifact(cfg, seed=args.seed, device=device)
        what = "seeded artifact"
    print(f"{what}: {len(artifact.records)} sites, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model} "
          f"({time.time() - t0:.1f}s)")

    lm = MarkovLM(vocab=cfg.vocab, k=8, seed=0)
    prompts = [lm.sample(1, 8, seed=100 + i)[0, :8].tolist()
               for i in range(args.requests)]
    eng = ServingEngine(artifact=artifact, n_slots=args.slots, max_len=128,
                        temperature=args.temperature, seed=args.seed,
                        use_kernel=args.kernel, kv_block=args.kv_block or None,
                        kv_blocks=args.kv_blocks,
                        prefix_cache=args.prefix_cache, tracer=True,
                        device=device, mesh=mesh)
    registries = [obs.get_global(), eng.metrics]
    srv = None
    if args.metrics_port is not None:
        srv = obs.start_metrics_server(registries, port=args.metrics_port)
        print(f"metrics: http://127.0.0.1:{srv.server_port}/metrics")
    try:
        _run(args, eng, prompts, registries)
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
    return eng


def _run(args, eng, prompts, registries) -> None:
    """Serve ``prompts`` through a scheduler, print the results and the
    end-of-run telemetry, write ``--trace-out`` / ``--metrics-out``."""
    sched = Scheduler(eng)
    on_token = ((lambda rid, tok: print(f"  req{rid} += {tok}", flush=True))
                if args.stream else None)
    t0 = time.time()
    rids = [sched.enqueue(p, max_new=args.max_new,
                          priority=args.requests - i,  # earlier = higher
                          on_token=on_token)
            for i, p in enumerate(prompts)]
    sched.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    res = [sched.take_result(r) for r in rids]
    tok = sum(len(r.tokens) - r.prompt_len for r in res)
    for i, r in enumerate(res):
        tag = f" [error: {r.error}]" if r.error else ""
        print(f"req{i}: prompt={r.tokens[:r.prompt_len]} -> "
              f"{r.tokens[r.prompt_len:]}{tag}")
    if eng.mesh is not None:
        where = f"mesh {args.dp}x{args.tp}"
    else:
        where = (torch.cuda.get_device_name(eng.device)
                 if eng.device.type == "cuda" else "cpu")
    print(f"{tok} tokens in {dt:.1f}s ({tok / dt:.1f} tok/s, "
          f"{args.slots} slots, {eng.step_dispatches} steps, "
          f"{eng.kernel_launches_per_step} kernel launches/step, {where})")
    ps = eng.pool_stats()
    if ps["n_blocks"]:
        print(f"kv pool: {ps['n_blocks']} blocks x {ps['block_size']} tok, "
              f"peak {ps['peak_in_use_blocks']} in use, "
              f"prefix hit-rate {ps['prefix_hit_rate']:.2f} "
              f"({ps['prefix_hit_tokens']} tok), {ps['cow_copies']} COW, "
              f"{ps['evictions']} evictions, "
              f"{sched.admitted_while_running} continuous admissions, "
              f"{sched.mem_stalls} block stalls")
    if eng.executor is not None:
        print(f"routed {len(eng.executor.routed)}/{len(eng.executor.sites)} "
              f"sites through fused kernels, {eng.n_layer_plans} layer plan(s); "
              f"plan fallbacks {eng.plan_stats()['fallbacks']}")

    # -------------------------------------------------- end-of-run telemetry
    tsum = eng.tracer.summary()
    prof = eng.profiler.summary()

    def ms(v):
        return "-" if v is None else f"{v * 1e3:8.1f}"

    print("telemetry summary")
    print(f"  {'metric':<14}{'p50 ms':>10}{'p99 ms':>10}{'n':>6}")
    for name in ("queue_wait_s", "ttft_s", "tpot_s", "e2e_s"):
        st = tsum[name]
        print(f"  {name[:-2]:<14}{ms(st['p50']):>10}{ms(st['p99']):>10}"
              f"{st['n']:>6}")
    print(f"  requests: {tsum['by_status']} ({tsum['open']} unclosed), "
          f"decode steps {prof['steps']}"
          + (f" @ {prof['tok_s']:.1f} tok/s" if prof["tok_s"] else ""))
    live = obs.live_roofline(eng)
    if live is not None:
        print(f"  live roofline: {live['total_lcc_adds']} lcc adds/token x "
              f"{live['decode_tok_s_n8']} tok/s = "
              f"{live['achieved_adds_per_s']} adds/s "
              f"({live['kernel_launches']} launches / "
              f"{live['n_layer_plans']} plans per step)")
    if args.trace_out:
        n_open = eng.tracer.dump_jsonl(args.trace_out)
        print(f"wrote {args.trace_out} ({tsum['completed']} spans, "
              f"{n_open} unclosed)")
    if args.metrics_out:
        obs.dump_metrics(args.metrics_out, registries,
                         trace_summary=tsum, profiler=prof,
                         live_roofline=live)
        print(f"wrote {args.metrics_out}")


if __name__ == "__main__":
    main()
