"""End to end through the unified compression API: train a small LM, run
the paper's Algorithm 1 over every compressible unit (``api.compress_model``
via the family adapter registry), save/load the resulting ``CompressedModel``
artifact through the msgpack+crc32 checkpointer, and SERVE batched requests
with EVERY compressed site — FFN and attention projections — executing on the
fused LCC kernels inside the decode step (``ServingEngine(artifact=...)``
builds a site-keyed ``CompressedExecutor``; this float32 model takes the
whole-step layer plan: ``stage_matmul`` and ``step_plan_matmul`` on the GPU).

    train -> compress_model -> CompressedModel.save -> load -> serve

    PYTHONPATH=src python examples/torch/transformer_compress_serve.py \\
        [--steps 60] [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.core import CompressionConfig
from repro_torch.core.artifact import CompressedModel
from repro_torch.data.synthetic import MarkovLM
from repro_torch.optim.optimizers import sgd
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.trainer import init_train_state, make_train_step
from repro_torch.models import api


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    cfg = reduced_config(get_arch(args.arch), vocab=64, n_layers=2, d_model=64,
                         d_ff=128, n_heads=4, n_kv_heads=4, head_dim=16)
    lm = MarkovLM(vocab=64, k=4, seed=0)
    print(f"== 1. train {args.arch}-reduced on a Markov stream "
          f"(entropy {lm.entropy:.2f} nats/token) ==")
    opt = sgd(momentum=0.9)
    state = init_train_state(0, cfg, opt, device=device)
    step = make_train_step(cfg, opt, lr=0.3)
    for i in range(args.steps):
        b = lm.batch(8, 32, seed=i)
        state, m = step(state, {k: torch.from_numpy(v).to(device)
                                for k, v in b.items()})
        if i % 20 == 0 or i == args.steps - 1:
            print(f"   step {i:3d}  loss {float(m['loss']):.3f}")
    params = {k: v for k, v in state.params.items()}

    print("== 2. Algorithm 1 over every FFN + attention projection ==")
    # every compressed site executes as fused kernel launches at serve time —
    # pass include="ffn." to restrict compression to the FFN projections
    art = api.compress_model(
        params, cfg,
        CompressionConfig(algorithm="fp", weight_sharing=True,
                          max_share_rel_err=0.06))
    print(art.report.table())

    print("== 3. artifact round-trip: compress once offline, serve many ==")
    with tempfile.TemporaryDirectory() as d:
        art.save(d)
        art = CompressedModel.load(d, device=device)
    n_packed = sum(1 for p in art.packed.values() if p.col_slices)
    print(f"   reloaded {len(art.records)} compressed units "
          f"({n_packed} with fused FP kernel buffers)")

    print("== 4. serve batched requests: original vs compressed-kernel ==")
    prompts = [lm.sample(1, 8, seed=100 + i)[0, :8].tolist() for i in range(6)]
    eng = ServingEngine(params, cfg, n_slots=4, max_len=64, device=device)
    eng_c = ServingEngine(artifact=art, n_slots=4, max_len=64, device=device)
    assert eng_c.executor is not None  # every site on the kernel path
    res = eng.generate(prompts, max_new_tokens=12)
    res_c = eng_c.generate(prompts, max_new_tokens=12)
    assert eng_c.executor.routed == eng_c.executor.sites  # all sites fused
    agree = np.mean([np.mean(np.array(a.tokens[a.prompt_len:])
                             == np.array(b.tokens[b.prompt_len:]))
                     for a, b in zip(res, res_c)])

    # token validity: generated tokens follow the chain's transition structure
    def validity(rs):
        ok = tot = 0
        for r in rs:
            for t in range(len(r.tokens) - 1):
                ok += r.tokens[t + 1] in lm.succ[r.tokens[t]]
                tot += 1
        return ok / tot
    print(f"   greedy-token agreement original vs compressed: {agree:.2%}")
    print(f"   chain-validity original {validity(res):.2%} | "
          f"compressed {validity(res_c):.2%}")
    print(f"   total adds ratio (all compressed sites): {art.report.ratio('lcc'):.1f}x")
    return {"agreement": float(agree), "artifact": art, "engine": eng_c,
            "adds_ratio": art.report.ratio("lcc")}


if __name__ == "__main__":
    main()
