#!/usr/bin/env bash
# CI entry point of the PyTorch/CUDA port (src/repro_torch): the tier-1 test
# suite and bounded smokes of the port's quickstart, its serve launcher's
# compressed path with telemetry, and the paged-KV prefix cache.  Reads no
# BENCH_*.json and runs no benchmark.
#
#   scripts/ci_torch.sh                 # from the repo root, on the CPU
#   DEVICE=cuda scripts/ci_torch.sh     # the smokes on a GPU
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
DEVICE="${DEVICE:-cpu}"
TMP="$(mktemp -d)"
trap 'rm -rf "$TMP"' EXIT

echo "== tier-1 test suite =="
python -m pytest -x -q

echo "== quickstart smoke (30s budget) =="
timeout 30 python examples/torch/quickstart.py --device "$DEVICE"

echo "== telemetry smoke: --compress --kernel (120s budget) =="
# the reduced olmo-1b compressed by the port (Algorithm 1, FP) and served
# through the whole-step layer plan with full telemetry: every span must
# close, every site be routed, and the live roofline be there (the artifact
# carries its cost report)
timeout 120 python -m repro_torch.launch.serve --reduced --device "$DEVICE" \
    --compress --kernel --requests 2 --max-new 8 --slots 2 \
    --metrics-out "$TMP/obs_metrics.json" --trace-out "$TMP/obs_trace.jsonl" \
    | tee "$TMP/serve.log"
python - "$TMP" "$DEVICE" <<'PY'
import json
import sys

tmp, device = sys.argv[1], sys.argv[2]
spans = [json.loads(l) for l in open(f"{tmp}/obs_trace.jsonl")]
assert len(spans) == 2, spans
assert all(s["status"] == "ok" for s in spans), spans
payload = json.load(open(f"{tmp}/obs_metrics.json"))
m = payload["metrics"]
launches = max(v["value"]
               for v in m["serving_kernel_launches_per_step"]["values"])
plans = m["serving_layer_plans"]["values"][0]["value"]
assert plans > 0, plans
# the float32 plan route launches 7 kernels a layer (2 layers reduced) on
# the GPU; on the CPU the wrappers run their plain versions, which count no
# launch
want = 7 * 2 if device.startswith("cuda") else 0
assert launches == want, (launches, want)
assert m["serving_requests_total"]["values"] == [
    {"labels": {"status": "ok"}, "value": 2}], m["serving_requests_total"]
roof = payload["live_roofline"]
assert roof and roof["sites"] and roof["achieved_adds_per_s"] > 0, roof
log = open(f"{tmp}/serve.log").read()
assert "routed 14/14 sites through fused kernels, 1 layer plan(s)" in log, log
print(f"telemetry smoke OK: 2/2 spans closed, {int(launches)} launches a "
      f"step ({int(plans)} layer plan), live roofline "
      f"{roof['achieved_adds_per_s']} adds/s")
PY

echo "== paged KV prefix-sharing smoke (60s budget) =="
# two requests sharing a system prompt: the second must prefill from cached
# pool blocks (>= 1 prefix hit) and shutdown must leak zero blocks
timeout 60 python - "$DEVICE" <<'PY'
import sys

from repro_torch.configs import get_arch, reduced_config
from repro_torch.models import api
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import Scheduler

device = sys.argv[1]
cfg = reduced_config(get_arch("olmo-1b"), d_model=32, n_heads=2, n_kv_heads=2,
                     head_dim=16, d_ff=48, vocab=64, n_layers=2)
params = api.init_params(0, cfg, device)
eng = ServingEngine(params, cfg, n_slots=2, max_len=64, kv_block=8,
                    device=device)
sched = Scheduler(eng)
system = [(5 * i + 3) % cfg.vocab for i in range(16)]  # shared system prompt
rids = [sched.enqueue(system + t, max_new=4) for t in ([7, 8], [9, 10, 11])]
sched.run()
res = [sched.take_result(r) for r in rids]
assert all(r.finished and r.error is None for r in res), res
s = eng.pool_stats()
assert s["prefix_hit_blocks"] >= 1, s
assert s["in_use_blocks"] == 0, s
print(f"prefix smoke OK: {s['prefix_hit_blocks']} blocks "
      f"({s['prefix_hit_tokens']} tokens) served from cache, zero leaks")
PY

echo "CI OK"
