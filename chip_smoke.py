#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # all phases, one GPU, no network

Drives the port's main paths — prox-regularized training (olmo-1b at full
width, the paper's MLP) and compressed serving at published width
through ``Scheduler`` + ``ServingEngine(artifact=...)``: olmo-1b (dense),
mixtral-8x22b (MoE, 8 experts top-2, cut to 1 layer), deepseek-v2-lite-16b
(MLA, 64 experts top-6 + 2 shared, cut to 1 layer) and qwen2.5-3b (QKV
bias, cut to 2 layers), each once through the
per-region route (bf16, kernels K1, K2 and K3's region prep; the experts as
grouped K2 launches of E) and once in float32 — olmo and mixtral through the whole-step layer plan
(K6 and K7; for mixtral K8, the routed FFN inside the step), deepseek (MLA
refuses the step plan) through one expert plan a layer (K9) beside per-region
MLA — and qwen2-vl-7b (m-RoPE, cut to 2 layers) per-region in both dtypes,
the recurrent families per-region in both dtypes — rwkv6-1.6b (ssm, cut to
2 layers) and zamba2-7b (hybrid, cut to 7 layers) — and the audio family's
whisper-small (encoder-decoder, per-region, cut to 2 + 2 layers) — plus K4's
per-factor route on olmo's layer 0, and holds every CUDA kernel on those paths against
its plain PyTorch version:

1. device and build: needs a CUDA device (exits non-zero without one), prints
   the card's name and power limit, builds the kernels with ``nvcc``; then
   the full-width float32 artifact and its layer plan (stage packing timed);
   ``--only chain`` instead times K1 and K2 alone at every shape the ten
   per-region serves launch them at (members drawn at the fixture's (N, K),
   no fixture, no serve, a few minutes) and stops; ``--only stage`` times K6
   alone at the 22 shapes of the six float32 plan routes, each in the
   modes the serve launches it in (gate+up and the experts' gates+ups
   gated: K7's SwiGLU in the epilogue; mixtral's experts' gates+ups also
   gathered: K8's dispatch read by the prep; mixtral's expert downs
   combining: K8's combine in the epilogue; one-layer full-width artifacts,
   no serve) and on the hand-built exact stages;
   ``--only attention`` times K7's decode attention alone (``step_attention``,
   one layer, paged) at the olmo-1b and mixtral-8x22b plan serves' shapes
   (S = 128, the serves' positions, idle rows) and at their long caches
   (olmo-1b S = 2048, mixtral-8x22b S = 4096 under its window), each at
   random positions and full, against its plain version, bitwise run to run,
   beside its bound and ``scaled_dot_product_attention``, and K8's route
   alone at mixtral's width; the full run starts with the same phase;
   ``--only prep`` times K3's region
   prep alone at every region the ten per-region serves prepare (members
   drawn at the fixture's widths, bf16 and, for deepseek's K9 route and
   qwen2-vl's float32 engine, float32 inputs laid out as the models pass
   them), bit for bit against its plain version and in its own order,
   beside one ``index_add_``, and K7's norm alone at the five plan serves'
   shapes (olmo-1b, mixtral-8x22b, qwen2.5-3b, llama3.2-3b, yi-9b)
   against its plain version, its own order and ``F.layer_norm`` /
   ``F.rms_norm``, in under a minute;
2. kernels: ``lcc_chain_matmul``, ``lcc_group_matmul``, ``region_prep``,
   ``stage_matmul`` (gate+up in its gated mode, K7's SwiGLU; a hand-built
   stage with a live dw block in the gathered mode, K8's dispatch),
   ``step_plan_matmul``, ``step_norm`` and ``step_attention`` at reduced
   shapes and at the main paths' own dimensions (the whole step also at
   olmo-1b's published context, S = 2048), and ``lcc_factor_matmul`` (K4) on
   every factor of layer 0's ``attn.o`` and ``ffn.down`` and through the
   per-factor route
   (``fused=False``) beside fused K1 (layer 0 of the full-width artifact and its plan, and
   one full-width step), each compared with its plain version and timed (CUDA
   events, L2 flushed between launches) beside a bound, the plain version and
   one library call where one computes the same function; the last phase
   fails if a serve launched a kernel at dimensions this phase did not check;
3. reduced serve: plan route == per-region route == plain route (CPU) ==
   dense-effective;
4. full-width serve, per-region route: olmo-1b in bf16 (the plan needs
   float32), d_model 2048, d_ff 8192, vocab 50304, the fixture's first
   OLMO_CUT_LAYERS layers;
5. full-width serve, plan route: the same model in float32, 16 layers; one
   step's logits against the per-region route on the same artifact; then
   the prefix cache (``--only prefix`` runs it alone; in the full run on
   the first OLMO_CUT_LAYERS layers): four prompts of one
   96-token head and their own 8-token tails on both routes, the prefix
   cache off (cold) and on (warm: the later requests prefill only their
   tail, ``prefill_extend`` against the gathered head), cold and warm
   prefill ms, hit tokens, COW copies, no block left in use, launches a
   step unchanged, the plan route's warm tokens identical to the cold
   ones (the bf16 route's first-step logits compared, a differing token
   reported with its margin); the reduced deepseek-v2-lite (MLA) warm ==
   cold and olmo-1b's tokenwise prefill == bulk; then the serving mesh
   (``mesh_serve``, the fixture's first MESH_SERVE_LAYERS layers on both
   routes: ``ServingEngine(mesh=)`` over a one-rank NCCL 1 x 1 mesh
   against the unsharded engine — tokens and two steps' logits bit for
   bit, launches a step equal, the collectives a step predicted, ms a
   step and peak bytes of both); then the artifact on disk
   (its own fixture, cut to ARTIFACT_LAYERS layers: saved, loaded through
   the map and served bit for bit the in-memory serves).
   ``--layers`` cuts the depth of both olmo serves (never the width);
6. mixtral-8x22b at full width (d_model 6144, 8 experts of d_ff 16384,
   vocab 32768), 1 layer: its K8 route and a
   reduced serve (plan == per-region == plain == dense, capacity drops
   occurring); the per-region kernels at its shapes and the bf16 per-region
   serve; then the plan packed and uploaded, K6 on its expert stages (eg
   gathered and gated; ed combining; each with a dropped choice and empty
   slots), one full-width step, and the float32 plan serve; plan vs
   per-region logits (``--only mixtral`` runs these alone);
7. deepseek-v2-lite-16b at full width (d_model 2048, MLA kv_lora 512, 64
   experts of d_ff 1408 top-6, 2 shared, vocab 102400), 1 layer: K9 on a
   reduced plan and a reduced serve (K9 route == per-region == plain ==
   dense, drops occurring); the per-region kernels at its shapes (uk+uv over
   the whole latent view at 1024 columns) and the bf16 per-region serve;
   one expert plan a layer packed and uploaded, K6 on every stage (stage A
   gated), K9 at
   layer 0, the float32 serve on the K9 route; K9 vs per-region logits
   (``--only deepseek`` runs these alone);
8. the rest of the dense family and the VLM, each at full width cut to
   QWEN_LAYERS layers (``--only qwen`` runs these alone): qwen2.5-3b (d
   2048, 16 heads over 2 kv heads, d_ff 11008, vocab 151936, tied, seeded
   non-zero q/k/v biases) on the bf16 per-region route and the float32
   plan (K6's ``qkv`` stage with its live bias in the epilogue, K7's norm
   and attention at G = 8), plan against per-region logits; qwen2-vl-7b
   (d 3584, 28 heads over 4, d_ff 18944, vocab 152064, m-RoPE) per-region
   only: its plan is refused with ``pos:mrope`` as in the reference, so its
   bf16 and its float32 engines both serve per-region (the prefix cache
   off), the float32 route's logits against the dense weights.
   ``--only dense`` serves llama3.2-3b and yi-9b the same way as
   qwen2.5-3b, cut to DENSE_LAYERS layers (left out of the full run);
   then the recurrent families (``--only recurrent`` runs these alone), at
   full width: rwkv6-1.6b (d 2048, 32 heads of 64, d_ff 7168, vocab 65536)
   cut to RWKV_LAYERS = 2 and zamba2-7b (d 3584, d_inner 7168, 112 SSM
   heads of 64, d_state 64; shared attention 32 x 112, d_ff 14336, vocab
   32000) cut to ZAMBA_LAYERS = 7 (one group of six mamba layers, the
   weight-shared block, one tail layer).  Both refuse the whole-step plan
   (``family:ssm`` / ``family:hybrid``, printed), so their float32 and
   bf16 engines serve per-region from a contiguous recurrent state,
   prefilling token by token into 8 slots (the full run serves float32
   only: the bf16 serves and their K3 rows run under ``--only
   recurrent``, for the script's time): K2 on rwkv6's r+k+v+g (four distinct
   inputs, one stacked buffer for K3) and k+r, K1 on o and v; K1 on
   mamba's in/out projections, K2 on the shared block's q+k+v and gate+up,
   K1 on its o and down; K3 on every region in both dtypes, each launch
   shape bit for bit against its plain version; the float32 route's
   two-step logits against the dense float32 weights within STEP_TOL;
   then the audio family (``--only audio`` runs it alone): whisper-small
   (d 768, 12 heads of 64, d_ff 3072, vocab 51865, ``max_decoder_len``
   448) cut to WHISPER_LAYERS = 2 encoder and 2 decoder layers in the full
   run (float32 only) and uncut (12 + 12) under ``--only audio`` in float32
   and bf16; the plan refused (``encoder_decoder``), so both engines serve
   per-region from a contiguous state, 8 slots over whisper's 30-second
   window (``max_len`` = 1500 encoder positions), each slot's static
   cross-KV filled from the port's encoder over its own seeded frames
   before the serve and unchanged after it, prefilling token by token:
   K2 on the decoder's q+k+v, K1 on attn.o, xattn.q (one launch shape with
   attn.o), xattn.o, fc1 and fc2, K3 on each region, each launch shape bit
   for bit; the float32 route's two-step logits against the dense float32
   weights within STEP_TOL;
9. training (``--only train`` runs these alone): K5 ``group_prox`` on the
   reference's hard cases and rows of every width to 16384 in float32 and
   bf16, then at the training runs' own views, each against its plain
   version and the oracle, bitwise from run to run, in place == out of
   place, timed; olmo-1b at full width (bf16, remat; the full run trains
   TRAIN_LAYERS layers, ``--only train`` all 16) trained by
   ``make_train_step`` with ProxSGD over every site (batch 8 x 512 tokens):
   a warm and five timed steps, 7 K5 launches a step, one step of the
   meshed step over a one-rank NCCL mesh against the unsharded step from
   the same state (bit for bit, ``meshed_step``), the update through K5
   against the other route, a profiled step; the paper's MLP through the
   port's launcher (``--arch mlp --prox``), 2 K5 launches a step;
   ``--only distributed`` (not in the full run beyond that one step and
   ``mesh_serve``): first the serving mesh — ``mesh_serve`` at
   MESH_SERVE_LAYERS layers and uncut, and mixtral-8x22b at
   MIXTRAL_LAYERS in float32 with ``moe_manual`` meshed 1 x 1 against
   unsharded, bit for bit — then olmo-1b training at full width on a
   one-rank NCCL world — the meshed step over
   1 x 1 against the unsharded step over MESH_STEPS steps from one state
   (every leaf, loss and grad norm bitwise, 7 K5 launches and the
   predicted collectives a step), the compressed step over 1 x 1 x 1 (the
   residuals' 2 rows -> 1), ``compressed_psum`` on layer 0's gradients
   bit for bit the CPU's and timed on the whole model's beside its byte
   bound, GPipe and the overlapped matmul at one rank, the train
   launcher's ``--mesh 1x1x1 --grad-compression`` and ``--mesh 1x1
   --elastic-demo``;
10. the compressor (``--only compress`` runs it alone, training the MLP
   first): the trained MLP (784-300-10) compressed at full width by
   ``models.api.compress_model`` on the card's host, under the compress
   launcher's default config and the train launcher's handoff config
   (dead inputs kept in place, so skipped and shrunk slice jobs), each at 1
   and at 4 worker processes (a forkserver pool), bit for bit the same;
   fc1 served through K1 on the held-out set (one launch a forward, bit for
   bit the plain version in the kernel's order, logits against the
   dense-effective forward and the CPU's plain route, accuracy dense ->
   compressed); recovery fine-tuning of the handoff artifact (60 steps,
   written back) and fc1 served again through one K1 launch, bit for bit,
   saved and loaded; the train launcher's whole loop (``--arch mlp --prox
   --epochs 12 --compress-out D --recover 60``, its ``train_stats.json`` on
   a line of its own); the reference launcher's --quickstart olmo-1b compressed by
   the port and served through ``ServingEngine(artifact=...)``, bf16 on the
   per-region route and float32 on the plan route, greedy tokens equal to
   the dense-effective forward's, launches a step as predicted;
   then ``examples/torch/quickstart.py`` in process (``quickstart``: its
   adds lines the reference's, its one K1 launch bit for bit the plain
   version in the kernel's order) and the serve launcher's ``--reduced
   --compress --kernel`` in process (``launcher_compress``: the report
   table printed, scripts/ci_torch.sh's telemetry gates, K6/K7 at its
   serve's dimensions); ``--only examples`` runs the three other examples
   (the MLP loop at full width, the ResNet grid, the transformer example)
   in process instead, each with its seconds and launches by shape;
11. ResNet-34 (``--only resnet`` runs it alone): the paper's second model at
   full width (widths 64-512, 36 conv sites, 200 classes) on the seeded conv
   artifact (``testing.seeded_conv_artifact``: a chain for every input
   channel), TinyImageNet-shaped 64 x 64 textures, in FK and in PK: the
   forward at B = 8 through ``CompressedExecutor`` (36 K2 launches, the
   head's K1 and its region prep), fused logits against the dense-effective
   ``F.conv2d`` forward, ``routed == sites``; K2 at every distinct conv
   launch shape (stem to stage 4, the 1x1 ``proj``) against its plain
   version, bit for bit in its order, beside its bound and one ``bmm``; at
   B = 8 and 32 ms a forward, images/s, peak device bytes, K2 ms by stage,
   a profiled forward and the cuDNN forward beside; then the reduced
   ResNet trained on the card as the reference's example trains it,
   compressed for real on the card's host (Table I: FK/PK x FP/FS), each
   artifact saved, loaded and served through ``ConvLCC`` (accuracy dense
   -> effective -> fused); then, inside the phase's share of the script,
   ResNet-34 compressed on every 32nd input channel and served (chains
   through K2 beside the residual conv).

The dry run (``launch/dryrun.py --arch all --shape all --mesh both``,
phase ``dryrun``) runs in a process of its own on the host from the start
of the full run, on the meta device; its 80 records are read at the end
(PASS / SKIP / FAIL counts, zero FAIL).

Telemetry (``repro_torch.obs``) is on in every serve, as the engine's
default: each ``serve`` fails unless the engine's registry counted the
steps it timed, the tokens it returned and the newest step's launches,
and the process-wide ``kernel_launches_total`` rose by every launch; the
olmo-1b serves' lines carry the step profiler's summary.  Besides: the
serve launcher in process with ``--metrics-out`` and ``--trace-out``
(after the reduced serve); telemetry's overhead on olmo-1b's float32 plan
route (full telemetry against ``metrics=False``, the best of three
attempts within 3 %, identical tokens; after the plan serve); the live
roofline of the quickstart olmo-1b on both routes (the compressor phase);
``record_step_metrics`` at olmo-1b's training steps.

One JSON object per line (a phase's line carries ``at_s``, the seconds since
the start); a failed phase ends the run with a non-zero exit.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import atexit
import gc
import json
import os
import resource
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import checkpointer, msgpack_codec  # noqa: E402
from repro_torch.checkpoint.checkpointer import _flatten  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.data.synthetic import MarkovLM  # noqa: E402
from repro_torch.kernels import build, dispatch, ops  # noqa: E402
from repro_torch.kernels.group_prox import (  # noqa: E402
    group_prox, group_prox_plain)
from repro_torch.kernels.ref import (  # noqa: E402
    group_prox_ref, lcc_factor_dense_ref)
from repro_torch.kernels.lcc_chain_matmul import (  # noqa: E402
    _levels_plain, _slice_inputs_plain, lcc_chain_matmul,
    lcc_chain_matmul_plain, plan_launch, signed_pow2)
from repro_torch.kernels.layer_plan import (  # noqa: E402
    _norm_launch, _rot, attention_key, device_stage, moe_plan_matmul,
    moe_plan_matmul_plain,
    plan_attention, plan_norm, stage_matmul, stage_matmul_plain,
    step_attention, step_attention_plain, step_norm, step_norm_plain,
    step_plan_matmul, step_plan_matmul_plain)
from repro_torch.kernels.lcc_matmul import (  # noqa: E402
    lcc_factor_matmul, lcc_factor_matmul_plain)
from repro_torch.kernels.lcc_group_matmul import (  # noqa: E402
    lcc_group_matmul, lcc_group_matmul_plain)
from repro_torch.kernels.moe_route import (  # noqa: E402
    capacity, moe_dispatch_plain, moe_route, moe_route_plain)
from repro_torch.kernels.shared_matmul import (  # noqa: E402
    RegionPrep, region_layout, region_prep_plain)
from repro_torch.models import api  # noqa: E402
from repro_torch.obs import (StepProfiler, get_global,  # noqa: E402
                             live_roofline)
from repro_torch.models.layers import _rope_sincos  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.executor import (  # noqa: E402
    CompressedExecutor, region_site, site_prep)
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.convert import F32_LEAVES  # noqa: E402
from repro_torch.testing import (SHARED_SITES,  # noqa: E402
                                 audio_sites, decomposition_dense,
                                 dense_sites, fill_cross_kv, moe_sites,
                                 seeded_artifact, seeded_decomposition,
                                 seeded_prep, unstacked_sites)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BATCH = 8  # decode batch of the main path (n_slots)
# |kernel - plain| <= SUM_TOL * max(1, max|plain|): both sum the E slice
# results in float32, the kernel slice by slice in launch order, torch.sum in
# its own order
SUM_TOL = 2e-5

KERNELS = {
    "lcc_chain_matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lcc_chain_matmul.cu",
        replaces="src/repro/kernels/lcc_chain_matmul.py:147"),
    "lcc_group_matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lcc_group_matmul.cu",
        replaces="src/repro/kernels/lcc_group_matmul.py:92"),
    # K3, one launch a fused region: prune gather, eq. (10) sums, concatenation
    "region_prep": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/cluster_segment_sum.cu",
        replaces="src/repro/kernels/shared_matmul.py:60"),
    "stage_matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/stage_matmul.cu",
        replaces="src/repro/kernels/layer_plan.py:483"),
    # K7's SwiGLU (line 414 of step_plan_matmul's body; for K9 line 454 of
    # moe_plan_matmul's): the gated epilogue of the gate/up stage
    "step_swiglu": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/stage_matmul.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    # K7's norm, lines 308-313 of step_plan_matmul's body
    "step_norm": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/step_plan.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    # K7's decode attention, lines 375-406 of step_plan_matmul's body
    "step_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/step_plan.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    # K8: the MoE branch of step_plan_matmul, body moe_block (:332-365)
    "moe_route": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/moe_route.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    # K8's dispatch (lines 350-354): the gathered input of stage eg
    "moe_dispatch": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/stage_matmul.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    # K8's gated combine (lines 358-365): the combining epilogue of stage ed
    "moe_combine": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/stage_matmul.cu",
        replaces="src/repro/kernels/layer_plan.py:418"),
    "group_prox": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/group_prox.cu",
        replaces="src/repro/kernels/group_prox.py:56"),
    "lcc_factor_matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lcc_factor_matmul.cu",
        replaces="src/repro/kernels/lcc_matmul.py:82"),
}
K9_REPLACES = "src/repro/kernels/layer_plan.py:457"  # moe_plan_matmul
# rows that check a composition of the kernels above (the whole step, K9):
# no launch of their own, so not in the kernels line
COMPOSITE = ("step_plan_matmul", "moe_plan_matmul")
# the stage's input and output modes: the kernel each takes the place of (a
# launch in the gathered mode is the dispatch's row, whatever its output mode)
MODE_ROW = {"gather": "moe_dispatch", "gated": "step_swiglu",
            "combine": "moe_combine"}
PER_REGION = ("lcc_chain_matmul", "lcc_group_matmul", "region_prep")
PLAN = ("stage_matmul", "step_norm", "step_attention")
MOE = ("moe_route",)
# the device kernels of this port, by name fragment (profiler rows)
PORT_KERNELS = ("lcc_chain_kernel", "lcc_reduce_kernel",
                "region_prep_kernel", "stage_prep_kernel",
                "stage_chain_kernel", "stage_epilogue_kernel",
                "step_norm_kernel", "split_attention_kernel",
                "split_attention_merge_kernel",
                "moe_logits_kernel", "moe_router_kernel",
                "group_prox_kernel", "lcc_factor_kernel")
ROUTED = ("moe.gate", "moe.up", "moe.down")  # site prefixes of the routed experts
# regions whose members read distinct inputs, views of one stacked buffer:
# the experts, and rwkv6's r/k/v/g (their four token-shifted mixes)
STACKED = ROUTED + ("tm.r",)
# the depth cuts keep the whole script well inside its time limit: 56
# mixtral layers do not fit one card, 27 deepseek-v2-lite layers need ~158 GB
# (PERF.md section 4), and one layer of each exercises every kernel its
# serves launch (every deepseek layer is an MoE layer; one since the dense
# family's and the VLM's phases joined the run)
MIXTRAL_LAYERS = 1
DEEPSEEK_LAYERS = 1
# qwen2.5-3b's 36 layers hold ~2.8 B site weights and qwen2-vl-7b's 28 ~6.5 B
# (2.6x and 6x olmo-1b's phase); two layers launch every kernel of each route
QWEN_LAYERS = 2
DENSE_LAYERS = 2  # llama3.2-3b and yi-9b, under --only dense
# the recurrent families: rwkv6-1.6b's 24 layers hold ~1.2 B site weights,
# zamba2-7b's 81 ~6.5 B; two rwkv6 layers launch every kernel of its route,
# and zamba2's seven run one group of six mamba layers, the shared block
# and one layer of the tail (81 = 13 x 6 + 3)
RWKV_LAYERS = 2
ZAMBA_LAYERS = 7
# whisper-small's 12 + 12 layers hold ~0.2 B site weights; its launch shapes
# do not depend on depth, so the full run serves 2 encoder + 2 decoder
# layers and ``--only audio`` the uncut model
WHISPER_LAYERS = 2
WHISPER_ENC = 1500  # whisper's 30-second encoder window: the cross-KV's rows
# olmo-1b's artifact on disk: 16 layers write ~35 GB to the temp directory
ARTIFACT_LAYERS = 2
# room in the full run for the serving mesh's check: olmo-1b's
# bf16 per-region serve and the prefix cache's serves run the first
# OLMO_CUT_LAYERS layers of the uncut fixture (whose float32 plan serve
# stays uncut; every layer launches the same kernels at the same shapes),
# and olmo-1b trains TRAIN_LAYERS layers
OLMO_CUT_LAYERS = 4
TRAIN_LAYERS = 8
MESH_SERVE_LAYERS = 2  # the full run's mesh_serve check
FACTOR_ROUTE = "olmo-1b per-factor"  # K4's path: fused=False on layer 0
MAX_LEN = 128  # the serves' KV view: 8 blocks of 16 tokens
# |step kernel - plain| <= STEP_TOL * max(1, max|plain|): float32 sums in
# other orders through every stage, norm and softmax of all the layers (each
# stage alone stays within SUM_TOL)
STEP_TOL = 1e-4
# plan route vs per-region route logits at full width: both float32, the
# chains evaluated in other groupings (fused CSD levels, one gather per
# stage) over 16 layers
ROUTE_TOL = 1e-3


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``at_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------- timing


class Timer:
    """Median device time of single launches, the L2 cache flushed before
    each (a decode step streams gigabytes between two launches of one site,
    so the real caller finds the cache cold).  A spin kernel is queued ahead
    of the first event so the host has enqueued everything before the device
    gets there: the events then bracket device time, not the wrapper's host
    time, which would swamp a kernel of a few microseconds."""

    SPIN_CYCLES = 1_000_000  # about half a millisecond at the card's clock

    def __init__(self, device, iters: int = 7):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        self.iters = iters

    def __call__(self, fn, cold: bool = True) -> float:
        fn()  # warm-up: first-launch set-up is not the kernel's time
        pairs = []
        for _ in range(self.iters):
            if cold:
                self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in pairs]))


# ------------------------------------------------------- phase 2: kernels


def dyadic(rng, shape, device):
    """Multiples of 1/8 in [-1, 1]."""
    return torch.from_numpy(rng.integers(-8, 9, size=shape).astype(np.float32)
                            / 8.0).to(device)


def levels_in_order(idx, exp, sign, cur):
    """:func:`_levels_plain` with every row's S terms summed as the kernel
    sums them: one after another, from +0.0 (a fused multiply-add by a power
    of two rounds as the add of the exact product)."""
    lead = idx.shape[:-3]
    p_factors, n, s = idx.shape[-3:]
    b = cur.shape[-1]
    coef = signed_pow2(sign, exp)
    for p in range(p_factors):
        ii = idx[..., p, :, :].reshape(*lead, n * s).long()
        g = torch.gather(cur, -2, ii[..., None].expand(*lead, n * s, b)
                         ).reshape(*lead, n, s, b)
        c = coef[..., p, :, :]
        acc = torch.zeros((*lead, n, b), dtype=torch.float32, device=cur.device)
        for t in range(s):
            acc = acc + c[..., t, None] * g[..., t, :]
        cur = acc
    return cur


def ordered_plain(ds, x, sm_count):
    """The plain version's per-slice results summed in the kernel's order:
    a row's terms one after another, slice by slice inside a block's chunk,
    then chunk by chunk."""
    idx = ds.idx if ds.idx.dim() == 5 else ds.idx[None]
    g, e, _, n, _ = idx.shape
    c0, w, ln = (t.reshape(g, e) for t in (ds.slice_c0, ds.slice_w, ds.chain_len))
    d = max(n, int(w.max()))
    per = levels_in_order(idx, ds.exp.reshape(idx.shape),
                          ds.sign.reshape(idx.shape),
                          _slice_inputs_plain(x, c0, w, d))  # [G, E, N, B]
    _, _, chunks, spb = plan_launch(n, x.shape[1], g, e, sm_count,
                                    idx.shape[-1])
    live = (ln > 0).cpu().numpy()
    out = torch.zeros((g, n, x.shape[1]), dtype=torch.float32, device=x.device)
    for gi in range(g):
        for c in range(chunks):
            acc = None
            for ei in range(c * spb, min(e, (c + 1) * spb)):
                if live[gi, ei]:
                    acc = per[gi, ei] if acc is None else acc + per[gi, ei]
            if acc is not None:
                out[gi] += acc
    return out


def live_terms(packed_list) -> int:
    """Terms the data needs: sign != 0 in real (not identity-padding) factors."""
    total = 0
    for pk in packed_list:
        for ei, ln in enumerate(pk.chain_lengths):
            total += int((pk.sign[ei, :ln] != 0).sum())
    return total


def chain_bound(packed_list, k_rows, b):
    """(bound_ms, bound_by): streams + input + output bytes over the memory
    rate against 2 operations per live term and column over the f32 rate.
    The output is the members' own rows (``out_dim``), not the padded rows
    the kernel's layout writes."""
    terms = live_terms(packed_list)
    n_out = sum(m.out_dim for m in packed_list)
    bytes_ = 6 * terms + 4 * b * (k_rows + n_out)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * terms * b / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, tol):
    err = float((got - want).abs().max())
    lim = tol * max(1.0, float(want.abs().max()))
    if not (err <= lim) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: max_abs_err {err:.3e} > {lim:.3e}")
    return err


def kernel_row(name, label, dims, key, err, exact, wrapper, plain, library,
               bound, timer, serve=None, **extra):
    """One row of the kernels line.  ``key`` is the dimension tuple under
    which the wrapper counts its launches (dispatch.launch_counts_by_shape);
    ``library`` is None where no single PyTorch call computes the function;
    ``serve`` names the full-width serve whose shapes the row checks (None
    for the reduced cases)."""
    ms = timer(wrapper)
    # one line a case as it completes: a later failure keeps the earlier ones
    emit(dict(phase="kernel_case", name=name, shape=label, ms=ms,
              max_abs_err=err))
    return dict(name=name, shape=label, dims=dims, shape_key=list(key),
                max_abs_err=err, max_err=err, exact_in_kernel_order=exact,
                ms=ms, kernel_ms=ms, **extra, plain_ms=timer(plain),
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=None if library is None else timer(library),
                serve=serve)


def kernel_case_chain(label, pk, rng, dev, timer, sm, batch=BATCH):
    """``lcc_chain_matmul`` on one packed decomposition at its own dims."""
    ds = pk.on(dev)
    k = pk.in_dim
    x = dyadic(rng, (k, batch), dev)
    args = (ds.idx, ds.exp, ds.sign, x, ds.slice_c0, ds.slice_w, ds.chain_len)
    y = lcc_chain_matmul(*args)
    torch.cuda.synchronize()
    plain = lcc_chain_matmul_plain(*args)
    err = check_close(label, y, plain, SUM_TOL)
    # in the kernel's order (a row's terms one after another, then slices
    # and chunks in launch order) the plain version matches bit for bit
    exact = True
    if not torch.equal(y[None], ordered_plain(ds, x, sm)):
        fail(f"{label}: kernel differs from the plain version summed in the "
             "kernel's own (fixed) slice order")
    w_eff = decomposition_dense(pk, dev)
    check_close(label + " vs dense", y[: pk.out_dim], w_eff @ x, 1e-4)
    e, p, n, s = pk.idx.shape
    return kernel_row(
        "lcc_chain_matmul", label, dict(E=e, P=p, N=n, S=s, K=k, B=batch),
        (e, p, n, s, k, batch), err, exact,
        lambda: lcc_chain_matmul(*args), lambda: lcc_chain_matmul_plain(*args),
        lambda: torch.matmul(w_eff, x), chain_bound([pk], k, batch), timer,
        warm_l2_ms=timer(lambda: lcc_chain_matmul(*args), cold=False))


def kernel_case_group(label, members, rng, dev, timer, sm, batch=BATCH):
    """``lcc_group_matmul`` on packed decompositions grouped as the executor
    groups them; members may differ in input width."""
    pg = ops.pack_group(members)
    ds = pg.on(dev)
    xs = [dyadic(rng, (m.in_dim, batch), dev) for m in members]
    x = torch.cat(xs)
    args = (ds.idx, ds.exp, ds.sign, x, ds.slice_c0, ds.slice_w, ds.chain_len)
    y = lcc_group_matmul(*args)
    torch.cuda.synchronize()
    plain = lcc_group_matmul_plain(*args)
    err = check_close(label, y, plain, SUM_TOL)
    if not torch.equal(y, ordered_plain(ds, x, sm)):
        fail(f"{label}: kernel differs from the plain version summed in the "
             "kernel's own (fixed) slice order")
    # the library yardstick is one bmm: members zero-padded to common dims
    g, e, p, n, s = pg.idx.shape
    k_max = max(m.in_dim for m in members)
    w_eff = torch.zeros((g, n, k_max), dtype=torch.float32, device=dev)
    xg = torch.zeros((g, k_max, batch), dtype=torch.float32, device=dev)
    for gi, (m, xm) in enumerate(zip(members, xs)):
        w_eff[gi, : m.out_dim, : m.in_dim] = decomposition_dense(m, dev)
        xg[gi, : m.in_dim] = xm
    check_close(label + " vs dense", y, torch.bmm(w_eff, xg), 1e-4)
    k = x.shape[0]
    return kernel_row(
        "lcc_group_matmul", label, dict(G=g, E=e, P=p, N=n, S=s, K=k, B=batch),
        (g, e, p, n, s, k, batch), err, True,
        lambda: lcc_group_matmul(*args), lambda: lcc_group_matmul_plain(*args),
        lambda: torch.bmm(w_eff, xg), chain_bound(members, k, batch),
        timer, warm_l2_ms=timer(lambda: lcc_group_matmul(*args), cold=False))


# ------------------------------------------------ K3: the region prep


def ordered_prep_plain(prep, xs):
    """The region prep in the kernel's own order, in PyTorch operations: each
    output row's segment of source rows summed in ascending order in float32,
    from +0.0 (-0.0 for a copied row, so a copy is exact)."""
    views, _ = region_layout(xs, prep.n_members)
    dev = views[0].device
    xall = torch.stack([v.to(torch.float32) for v in views])  # [G, K, B]
    src, seg, info = (torch.from_numpy(a).to(dev).long()
                      for a in (prep.src, prep.segptr, prep.rowinfo))
    lens = seg[1:] - seg[:-1]
    acc = torch.zeros((prep.rows, xall.shape[2]), dtype=torch.float32,
                      device=dev)
    acc[(info & 1).bool()] = -0.0
    member = info >> 1
    for t in range(int(lens.max()) if lens.numel() else 0):
        j = torch.clamp(seg[:-1] + t, max=max(src.numel() - 1, 0))
        acc = torch.where((t < lens)[:, None], acc + xall[member, src[j]], acc)
    return acc


def prep_input(g, k, batch, dtype, stacked, rng, dev, exact=True):
    """A region's input as the models pass it: the transposed view of one
    ``[B, K]`` activation shared by the G members, or (``stacked``) one view
    ``z[e].T`` an expert into a ``[G, B, K]`` buffer.  Dyadic values
    (``exact``: every sum exact, in bf16 too) or standard normal ones."""
    shape = (g, batch, k) if stacked else (batch, k)
    x = (dyadic(rng, shape, dev) if exact else torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)).to(dtype)
    return [x[e].T for e in range(g)] if stacked else x.T


def prep_bound(prep, stacked, batch, itemsize):
    """(bound_ms, bound_by): the input rows the region reads, once (a shared
    input's rows once for all members), its tables and its output, over the
    memory rate; one add a column for every row of a segment past its
    first, over the float32 rate."""
    segs = [prep.src[prep.segptr[a]:prep.segptr[b]]
            for a, b in zip(prep.out_off[:-1], prep.out_off[1:])]
    rows_read = (sum(np.unique(s).size for s in segs) if stacked
                 else np.unique(prep.src).size)
    lens = np.diff(prep.segptr)
    adds = int(np.clip(lens - 1, 0, None).sum()) * batch
    bytes_ = (rows_read * batch * itemsize
              + 4 * (prep.src.size + prep.segptr.size + prep.rowinfo.size)
              + 4 * prep.rows * batch)
    return bound_of(bytes_, adds)


def kernel_case_prep(label, prep, k, batch, dtype, stacked, dev, timer,
                     serve=None):
    """K3's region prep on one region at its serve's dims and layout: bit for
    bit against the plain version (per-member ``index_select``,
    ``index_add_``, ``torch.cat``) on dyadic input, against
    :func:`ordered_prep_plain` on dyadic and on random input, and from run
    to run.  Library: one ``index_add_`` of the region's source rows,
    gathered beforehand, into its output rows."""
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    g = prep.n_members
    xs = prep_input(g, k, batch, dtype, stacked, rng, dev)
    y, again = prep(xs), prep(xs)
    torch.cuda.synchronize()
    if not torch.equal(y, again):
        fail(f"{label}: region prep differs from run to run")
    if not torch.equal(y, region_prep_plain(prep, xs)):
        fail(f"{label}: region prep differs from its plain version on dyadic "
             "input")
    if not torch.equal(y, ordered_prep_plain(prep, xs)):
        fail(f"{label}: region prep differs from its own order (dyadic)")
    xr = prep_input(g, k, batch, dtype, stacked, rng, dev, exact=False)
    if not torch.equal(prep(xr), ordered_prep_plain(prep, xr)):
        fail(f"{label}: region prep differs from its own order (random)")
    del xr
    lens = np.diff(prep.segptr)
    views, _ = region_layout(xs, g)
    member = torch.from_numpy(np.repeat(prep.rowinfo >> 1, lens)).to(dev).long()
    tgt = torch.from_numpy(np.repeat(np.arange(prep.rows), lens)).to(dev)
    xg = torch.stack([v.to(torch.float32) for v in views])[
        member, torch.from_numpy(prep.src).to(dev).long()]
    out = torch.empty((prep.rows, batch), dtype=torch.float32, device=dev)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return kernel_row(
        "region_prep", label,
        dict(G=g, K=k, R=prep.rows, nnz=int(prep.src.size), B=batch,
             dtype=str(dtype).removeprefix("torch."),
             layout="stacked" if stacked else "shared"),
        prep.shape_key(k, batch, itemsize), 0.0, True, lambda: prep(xs),
        lambda: region_prep_plain(prep, xs),
        lambda: out.zero_().index_add_(0, tgt, xg),
        prep_bound(prep, stacked, batch, itemsize), timer, serve=serve)


def region_preps(cfg, records=None, seed=0):
    """``(label, prep, K, B, stacked, names)`` of layer 0's regions as the
    per-region route prepares them (:func:`site_groups`): from ``records``
    (an artifact's) or, without them, members drawn as the fixture draws
    them (``testing.seeded_prep``: the same widths and table sizes).  B is
    n_slots, the capacity for the experts (views of one stacked buffer) and
    n_slots x max_len for MLA's uk+uv over the latent view."""
    k_of = {p: k for p, _, _, k in dense_sites(cfg) + moe_sites(cfg)
            + unstacked_sites(cfg) + audio_sites(cfg)}
    cap = (capacity(BATCH, cfg.moe.top_k, cfg.moe.capacity_factor,
                    cfg.moe.n_experts) if cfg.moe is not None else None)
    rng = np.random.default_rng(seed)
    out = []
    for names in site_groups(cfg) + shared_groups(cfg):
        prefixes = [region_site(n) for n in names]
        k = k_of[prefixes[0]]
        stacked = prefixes[0] in STACKED
        batch = (cap if prefixes[0] in ROUTED else BATCH * MAX_LEN
                 if prefixes[0] == "attn.uk" else BATCH)
        if records is not None:
            prep = site_prep([records[n] for n in names])
        else:
            prep = RegionPrep([
                (kept, labels, k_dec) for kept, labels, k_dec in (
                    seeded_prep(k_of[p], rng, p in SHARED_SITES)
                    for p in prefixes)], "+".join(dict.fromkeys(prefixes)))
        label = (f"{prefixes[0]} G={len(names)}" if prefixes[0] in ROUTED
                 else "+".join(prefixes))
        out.append((f"{cfg.name} {label}", prep, k, batch, stacked, names))
    return out


def region_cases(cfg, dev, timer, *, records=None, dtype=torch.bfloat16,
                 serve=None, keep=None):
    """:func:`kernel_case_prep` on every region of :func:`region_preps`
    (``keep(names)`` filters them) whose prep launches."""
    rows = []
    for label, prep, k, batch, stacked, names in region_preps(cfg, records):
        if (keep is not None and not keep(names)) or (
                prep.identity and prep.rows == k):
            continue
        rows.append(kernel_case_prep(label, prep, k, batch, dtype, stacked,
                                     dev, timer, serve=serve))
    torch.cuda.empty_cache()
    return rows


def region_preps_per_step(cfg, records, keep=None) -> int:
    """Region-prep launches a decode step of the per-region route: one a
    fused region of every layer and one a single site that prunes or shares
    (a site with an identity keep and no sharing takes none), the hybrid's
    shared block's regions once an insertion; ``keep(names)`` filters the
    regions."""
    n = 0
    runs = [site_groups(cfg, li) for li in range(cfg.n_layers)]
    runs += [shared_groups(cfg)] * shared_insertions(cfg)
    for groups in runs:
        for names in groups:
            if keep is not None and not keep(names):
                continue
            prep = site_prep([records[nm] for nm in names])
            n += not (prep.identity and len(names) == 1)
    return n


def reduced_kernel_cases(cfg, dev, timer, sm):
    """Every kernel at the reduced widths, plus what the full-width path does
    not reach: other term counts per row and ragged batch widths."""
    d, dff = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(10)

    def pack(n, k, **kw):
        return ops.pack_decomposition(seeded_decomposition(n, k, rng, **kw))

    rows = [kernel_case_chain("reduced attn.o", pack(d, d), rng, dev, timer, sm),
            kernel_case_chain("reduced ffn.down", pack(d, dff), rng, dev, timer, sm),
            kernel_case_group("reduced attn.qkv", [pack(d, d) for _ in range(3)],
                              rng, dev, timer, sm),
            kernel_case_group("reduced ffn.gate+up", [pack(dff, d) for _ in range(2)],
                              rng, dev, timer, sm)]
    rows += region_cases(cfg, dev, timer, dtype=torch.float32)
    for label, prep, k, _, stacked, _ in region_preps(cfg, seed=1)[:1]:
        for batch in (3, 13):  # ragged column chunks of the region prep
            rows.append(kernel_case_prep(f"{label} B={batch}", prep, k, batch,
                                         torch.bfloat16, stacked, dev, timer))
    for s_terms in (1, 3):
        rows.append(kernel_case_chain(f"reduced attn.o S={s_terms}",
                                      pack(d, d, s_terms=s_terms), rng, dev,
                                      timer, sm))
    for batch in (1, 5, 13):  # a ragged last block of columns
        rows.append(kernel_case_chain(f"reduced ffn.down B={batch}", pack(d, dff),
                                      rng, dev, timer, sm, batch=batch))
    rows.append(kernel_case_group("reduced attn.qkv B=3",
                                  [pack(d, d) for _ in range(3)], rng, dev,
                                  timer, sm, batch=3))
    return rows


def main_path_kernel_cases(art, dev, timer, sm):
    """Every kernel at exactly the dimensions the full-width serve launches
    it at: layer 0's own packed decompositions, grouped as the executor groups
    them, and the label vectors of its weight-shared sites, at B = n_slots."""
    rng = np.random.default_rng(20)
    pk = art.packed
    rows = [kernel_case_chain(f"full {site}", pk[f"{site}.l0"], rng, dev, timer, sm)
            for site in ("attn.o", "ffn.down")]
    for label, names in (("attn.qkv", ("attn.q", "attn.k", "attn.v")),
                         ("ffn.gate+up", ("ffn.gate", "ffn.up"))):
        rows.append(kernel_case_group(f"full {label}",
                                      [pk[f"{n}.l0"] for n in names], rng, dev,
                                      timer, sm))
        torch.cuda.empty_cache()
    rows += region_cases(art.config, dev, timer, records=art.records,
                         serve=f"{art.config.name} per-region")
    return rows


# --------------------------------------- --only chain: K1/K2 main-path shapes


def fixture_k(k: int, shared: bool) -> int:
    """Input width of a site's decomposition as ``testing.seeded_artifact``
    makes it: 2 pruned columns, and a weight-shared site's centroids (a
    sixteenth of the kept columns merged)."""
    kept = k - min(2, k - 2)
    return kept - max(1, kept // 16) if shared else kept


def chain_cases(arch):
    """The K1/K2 launches of one model's per-region serve, as ``(label, site
    prefixes, batch, [(N, K)] a member)``: the fixture's own dimensions of
    layer 0, grouped as the executor groups them; the experts as one group
    of E at B = capacity, ``uk+uv`` over the whole latent view."""
    cfg = get_arch(arch)
    dims = {prefix: (n, k) for prefix, _, n, k in dense_sites(cfg)}
    dims.update({prefix: (n, k) for prefix, _, n, k in moe_sites(cfg)})
    dims.update({name: (n, k) for name, _, n, k in unstacked_sites(cfg)
                 + audio_sites(cfg)})
    chains = [("attn.o",), ("ffn.down",)]
    groups = [(("attn.q", "attn.k", "attn.v"), BATCH),
              (("ffn.gate", "ffn.up"), BATCH)]
    if cfg.family in ("ssm", "hybrid", "audio"):  # layer 0's regions, the shared block's
        regions = [tuple(region_site(n) for n in g)
                   for g in site_groups(cfg) + shared_groups(cfg)]
        chains = [g for g in regions if len(g) == 1]
        groups = [(g, BATCH) for g in regions if len(g) > 1]
    elif cfg.mla is not None:
        chains = [("attn.q",), ("attn.o",), ("moe.shared.down",)]
        groups = [(("attn.dkv", "attn.kr"), BATCH),
                  (("attn.uk", "attn.uv"), BATCH * MAX_LEN),
                  (("moe.shared.gate", "moe.shared.up"), BATCH)]
    elif cfg.moe is not None:
        chains = [("attn.o",)]
        groups = [(("attn.q", "attn.k", "attn.v"), BATCH)]
    if cfg.moe is not None:
        ne = cfg.moe.n_experts
        cap = capacity(BATCH, cfg.moe.top_k, cfg.moe.capacity_factor, ne)
        groups += [((f"moe.{proj}",) * ne, cap) for proj in ("gate", "up", "down")]
    out, seen = [], {}
    for names, batch in [(c, BATCH) for c in chains] + groups:
        members = [(dims[nm][0], fixture_k(dims[nm][1], nm in SHARED_SITES))
                   for nm in names]
        label = names[0] if len(names) == 1 else (
            f"{names[0]} G={len(names)}" if len(set(names)) == 1 else
            names[0] + "+" + "+".join(nm.rsplit(".", 1)[1] for nm in names[1:]))
        key = (tuple(members), batch)
        if key in seen:  # one launch shape of two sites (whisper's attn.o
            # and xattn.q): one case, both names in its label
            i = seen[key]
            lab, nm, b, mem = out[i]
            out[i] = (lab.replace(f" B={b}", f"|{label} B={b}"), nm, b, mem)
            continue
        seen[key] = len(out)
        out.append((f"{arch} {label} B={batch}", names, batch, members))
    return out


def phase_chain(dev):
    """``--only chain``: K1 and K2 at every shape the per-region serves of
    PREP_ARCHS launch them at, members drawn
    by ``testing.seeded_decomposition`` at the fixture's (N, K) — no fixture,
    no serve.  Each case as in the kernel phase: bit for bit against the
    plain version in the kernel's order, against the dense product, timed
    beside its bound, the plain version and one library call."""
    t0 = time.perf_counter()
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    with ThreadPoolExecutor(max_workers=8) as pool:
        for arch in PREP_ARCHS:
            for ci, (label, names, batch, members) in enumerate(chain_cases(arch)):
                def draw(job):
                    mi, (n, k) = job
                    rng = np.random.default_rng((30, ci, mi))
                    return ops.pack_decomposition(seeded_decomposition(n, k, rng))
                t_draw = time.perf_counter()
                packed = list(pool.map(draw, enumerate(members)))
                draw_s = time.perf_counter() - t_draw
                rng = np.random.default_rng((31, ci))
                if len(members) == 1:
                    row = kernel_case_chain(label, packed[0], rng, dev, timer,
                                            sm, batch=batch)
                else:
                    row = kernel_case_group(label, packed, rng, dev, timer, sm,
                                            batch=batch)
                row.update(draw_s=draw_s,
                           geometry=list(plan_launch(
                               row["dims"]["N"], batch, row["dims"].get("G", 1),
                               row["dims"]["E"], sm, row["dims"]["S"])))
                rows.append(row)
                del packed
                gc.collect()
                torch.cuda.empty_cache()
    return dict(phase="chain", seconds=time.perf_counter() - t0,
                tolerance=SUM_TOL, rows=rows)


# ------------------------------------------------ K6 and K7: layer plans


def bound_of(bytes_, flops):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def stage_cost(ds, layers, batch) -> tuple[int, int]:
    """(bytes, operations) one stage needs for ``layers``: the live terms its
    data needs, in the levels of ``stage_blocks``' pieces, not the kernel's
    slices (6 bytes and one multiply-add per batch column each),
    the nonzero dense blocks, input and output read/written once."""
    ps = ds.ps
    bytes_ = flops = 0
    for l in layers:
        terms = ds.live_terms[l] if ps.has_fp else 0
        dense = (ps.out_dim * ps.k_alloc if ds.fs_live[l] else 0) + \
            (ps.out_dim * ps.d_src if ds.dw_live[l] else 0)
        bytes_ += 6 * terms + 4 * dense + 4 * batch * (ps.d_src + ps.out_dim)
        flops += 2 * (terms + dense) * batch
    return bytes_, flops


STAGE_SITES = {"qkv": (("attn", "q"), ("attn", "k"), ("attn", "v")),
               "o": (("attn", "o"),), "gu": (("ffn", "gate"), ("ffn", "up")),
               "dn": (("ffn", "down"),)}


def stage_weights(art, name, layer, dev):
    """One stage's dense-effective ``[O, D_src]`` float32 matrix of one layer,
    from the artifact's parameters (never from the folded ``eff``)."""
    blocks = art.params["blocks"]
    return torch.cat([blocks[b][p]["w"][layer].to(dev, torch.float32).T
                      for b, p in STAGE_SITES[name]]).contiguous()


def ordered_stage_plain(ps, src, layer, sm_count, plan=None, *, gated=False,
                        combine=None, gather=None):
    """``stage_matmul``'s result for one layer in the kernels' own order, in
    PyTorch operations: the input ``src`` or, with ``gather``, what
    :func:`ordered_gather` reads; the prep sums each target's pairs in pair order
    (the sorted-pair order of the prep kernel); a row's terms are added in
    slot order from 0; each chunk of :meth:`DeviceStage.launch` sums its
    slices' output rows in slice order from 0 (an entry that reads the zero
    row adds 0), and the epilogue the chunks of a site in chunk order from
    0, then the dense blocks (one product each, so only there is the order
    PyTorch's), the bias and nothing else; in the gated mode then
    :func:`ordered_swiglu`, in the combining mode :func:`ordered_combine`.
    Equal to the kernel bit for bit where the stage has no live dense
    block.  ``plan``: the launch to follow (a :class:`StageLaunch` of
    ``layer`` alone; default the wrapper's)."""
    if gather is not None:
        src = ordered_gather(ps, *gather)
    ds = device_stage(ps, src.device)
    dev, b = src.device, src.shape[1]
    x = src.to(torch.float32)
    out = torch.zeros((ps.out_dim, b), dtype=torch.float32, device=dev)
    inbuf = None
    if ps.has_prep:
        tgt, order = torch.sort(ds.prep_tgt[layer].long(), stable=True)
        pairs = ds.prep_src[layer].long()[order]
        rank = torch.arange(tgt.numel(), device=dev) - torch.searchsorted(tgt, tgt)
        inbuf = torch.zeros((ps.k_alloc, b), dtype=torch.float32, device=dev)
        for k in range(int(rank.max()) + 1):  # targets unique within a rank
            at = rank == k
            inbuf[tgt[at]] = inbuf[tgt[at]] + x[pairs[at]]
    if ps.has_fp:
        n_p, r, n_s = ps.gidx.shape[1:]
        work = None
        for p in range(n_p):
            buf = inbuf if p == 0 else work
            acc = torch.zeros((r, b), dtype=torch.float32, device=dev)
            for s in range(n_s):
                coef = signed_pow2(ds.gsgn[layer, p, :, s], ds.gexp[layer, p, :, s])
                acc = acc + coef[:, None] * buf[ds.gidx[layer, p, :, s].long()]
            work = acc
        m = ds.maps[layer]
        plan = plan or ds.launch(b, layer, sm_count)
        sums = {}
        for _, u, e0, e1 in plan.chunks:  # in the order of the sites' chunks
            a, w, first = (int(v) for v in m.sites[u, :3])
            acc = torch.zeros((w, b), dtype=torch.float32, device=dev)
            for e in range(first + e0, first + e1):
                rows = work[int(m.slices[e, 0]): int(m.slices[e, 0]) + w]
                if e in m.holes:
                    rows = rows.clone()
                    rows[torch.as_tensor(m.holes[e], device=dev)] = 0.0
                acc = acc + rows
            sums.setdefault(u, []).append(acc)
        for u, parts in sums.items():
            a, w = int(m.sites[u, 0]), int(m.sites[u, 1])
            g = torch.zeros((w, b), dtype=torch.float32, device=dev)
            for part in parts:
                g = g + part
            out[a: a + w] = g
    if ds.fs_live[layer]:
        out = out + ds.fs_mat[layer] @ inbuf
    if ds.dw_live[layer]:
        out = out + ds.dw_mat[layer] @ x
    if ds.bias_live[layer]:
        out = out + ds.bias[layer][:, None]
    if gated:
        return ordered_swiglu(out)
    if combine is not None:
        return ordered_combine(out, *combine)
    return out


def ordered_gather(ps, h2, slot, src_tok):
    """The gathered input ``[E * d, cap]`` as the stage's kernel reads it:
    ``h2[i, src_tok[e * cap + c]]`` at row ``e * d + i`` and column c (a
    -0.0 of h2 as it is), +0.0 where ``src_tok`` is -1; ``slot`` is not
    read."""
    d = h2.shape[0]
    n_exp = ps.d_src // d
    tok = src_tok.long().reshape(n_exp, 1, -1)
    rows = torch.arange(d, device=h2.device)[None, :, None]
    v = h2.to(torch.float32)[rows, tok.clamp(min=0)]
    return torch.where(tok >= 0, v, 0.0).reshape(n_exp * d, -1)


def ordered_swiglu(out):
    """The gated epilogue's expression on ``out [2 n, B]`` one rounded
    operation at a time: ``(g / (1 + exp(-g))) * u``, g the first n rows, u
    the last n."""
    n = out.shape[0] // 2
    g, u = out[:n], out[n:]
    return torch.div(g, torch.exp(-g) + 1.0) * u


def ordered_combine(ob, x, slot, wgt):
    """The combining epilogue's sums from the expert outputs ``ob [E * d,
    cap]``: ``x [d, T] + y``, y from 0 adding ``wgt[t, j] * ob[e_j * d + r,
    c_j]`` (a product, then a sum) over the choices j in order, a dropped
    one (slot outside ``[0, E * cap)``) by a select that keeps y."""
    d, t = x.shape
    cap = ob.shape[1]
    n_exp = ob.shape[0] // d
    s = slot.long()
    kept = (s >= 0) & (s < n_exp * cap)
    s = torch.where(kept, s, torch.zeros_like(s))
    e, c = s // cap, s % cap
    rows = torch.arange(d, device=x.device)[:, None]
    y = torch.zeros_like(x)
    for j in range(s.shape[1]):
        v = ob[e[:, j][None, :] * d + rows, c[:, j][None, :].expand(d, t)]
        y = torch.where(kept[:, j][None, :], y + wgt[:, j][None, :] * v, y)
    return x + y


def combine_inputs(d, t, k, n_exp, cap, seed, dev):
    """``(x [d, T], slot [T, k], wgt [T, k])`` as the route gives them:
    each token's k experts distinct, ranked in token-major order, a rank
    beyond ``cap`` dropped (slot ``E * cap``, weight 0), the weights a
    token's renormalised gates; token 1's last choice is dropped whatever
    its rank, and some slots stay empty (``T * k < E * cap``)."""
    rng = np.random.default_rng(seed)
    fill = np.zeros(n_exp, np.int64)
    slot = np.empty((t, k), np.int32)
    wgt = rng.uniform(0.1, 1.0, (t, k)).astype(np.float32)
    wgt /= wgt.sum(axis=1, keepdims=True)
    for ti in range(t):
        for j, e in enumerate(rng.permutation(n_exp)[:k]):
            if fill[e] < cap and not (ti == 1 and j == k - 1):
                slot[ti, j] = e * cap + fill[e]
                fill[e] += 1
            else:
                slot[ti, j] = n_exp * cap
                wgt[ti, j] = 0.0
    x = torch.from_numpy(rng.standard_normal((d, t)).astype(np.float32))
    return (x.to(dev), torch.from_numpy(slot).to(dev),
            torch.from_numpy(wgt).to(dev))


def gather_inputs(d, t, k, n_exp, cap, seed, dev):
    """``(h2 [d, T], slot [T, k], src_tok [E * cap])`` as the route gives
    them: :func:`combine_inputs`' slots (token 1's last choice dropped,
    some slots empty) and each kept slot's token; h2 dyadic, with -0.0 in
    token 0's column (routed: the first token takes the first ranks)."""
    _, slot, _ = combine_inputs(d, t, k, n_exp, cap, seed, "cpu")
    s = slot.long()
    kept = s < n_exp * cap
    src_tok = torch.full((n_exp * cap,), -1, dtype=torch.int32)
    src_tok[s[kept]] = torch.arange(t)[:, None].expand_as(s)[kept].to(torch.int32)
    h2 = dyadic(np.random.default_rng(seed), (d, t), "cpu")
    h2[0, 0] = -0.0
    return h2.to(dev), slot.to(dev), src_tok.to(dev)


def mode_kwargs(ps, batch, mode, dev):
    """``stage_matmul``'s keywords for a mode: ``None`` (plain),
    ``"gated"``, ``("combine", E, T, k)`` with :func:`combine_inputs` (cap
    = ``batch``), or ``("gather", E, T, k, output mode)`` with
    :func:`gather_inputs` and the output mode's keywords; and the modes'
    part of the launch's shape key."""
    if mode is None:
        return {}, ()
    if mode == "gated":
        return {"gated": True}, ("gated",)
    if mode[0] == "gather":
        _, n_exp, t, k, out_mode = mode
        kw, key = mode_kwargs(ps, batch, out_mode, dev)
        d = ps.d_src // n_exp
        return ({**kw, "gather": gather_inputs(d, t, k, n_exp, batch, 74, dev)},
                ("gather", d, t) + key)
    _, n_exp, t, k = mode
    return ({"combine": combine_inputs(ps.out_dim // n_exp, t, k, n_exp,
                                       batch, 73, dev)}, ("combine", t, k))


def mode_row(key_mode) -> str:
    """The kernels line's row of a stage launch in ``key_mode`` (the modes'
    part of its shape key): the kernel the first mode takes the place of."""
    return MODE_ROW[key_mode[0]] if key_mode else "stage_matmul"


def stage_input(ps, kw, rng, batch, dev):
    """``(src, arg)``: the dense input ``[D_src, B]`` a case's stage reads
    (dyadic; in the gathered mode the experts' input as the plain dispatch
    forms it from ``kw["gather"]``) and what ``stage_matmul`` takes as
    ``src`` (None in the gathered mode)."""
    if "gather" in kw:
        h2, slot, src_tok = kw["gather"]
        return moe_dispatch_plain(h2, slot, src_tok, ps.d_src // h2.shape[0],
                                  batch), None
    src = dyadic(rng, (ps.d_src, batch), dev)
    return src, src


def mode_cost(ds, layer, batch, kw) -> tuple[int, int]:
    """(bytes, operations) of the stage in its modes: the stage's own
    (:func:`stage_cost`), its input replaced by the gathered mode's (h2 and
    src_tok read once) and its output by the output mode's (the gated half
    rows, with four operations an element: exp, add, divide, multiply; the
    combine's ``[d, T]`` with x, slot and wgt read, two operations a choice
    and one add)."""
    bytes_, flops = stage_cost(ds, [layer], batch)
    if "gather" in kw:
        h2, _, src_tok = kw["gather"]
        bytes_ += 4 * (h2.numel() + src_tok.numel() - batch * ds.ps.d_src)
    o = ds.ps.out_dim
    if kw.get("gated"):
        return bytes_ - 4 * batch * (o - o // 2), flops + 4 * (o // 2) * batch
    if "combine" in kw:
        x, slot, _ = kw["combine"]
        d, t = x.shape
        k = slot.shape[1]
        return (bytes_ - 4 * batch * o + 4 * 2 * d * t + 8 * t * k,
                flops + (2 * k + 1) * d * t)
    return bytes_, flops


def stage_dims(ds, batch, layer=0):
    """The stage's dimensions and the chain kernel's geometry at ``batch``
    columns (what a launch of one layer runs: a geometry a group of sites)."""
    d = ds.dims
    sm = torch.cuda.get_device_properties(ds.device).multi_processor_count \
        if ds.device.type == "cuda" else 132
    plan = ds.launch(batch, layer, sm)
    m = ds.maps[layer] if ds.maps else None
    return dict(P=d["P"], R=d["R"], S=d["S"], K=d["K"], D=d["D"], O=d["O"],
                J=d["J"], B=batch, sites=0 if m is None else int(m.sites.shape[0]),
                slices=0 if m is None else int(m.slices.shape[0]),
                max_rows=ds.max_rows,
                level0_window=0 if m is None else int(np.diff(m.window).max()),
                geometries=plan.geometries,
                chunks=plan.n_units,
                blocks=sum(g[1] * -(-batch // g[2]) for g in plan.groups))


def kernel_case_stage(label, ps, rng, dev, timer, *, layer=0, batch=BATCH,
                      exact=False, w=None, mode=None):
    """``stage_matmul`` on one layer of one stage at ``batch`` columns, held
    against its plain version (bit for bit when ``exact``: dyadic input on a
    stage whose every sum is exact), against the plain arithmetic in the
    kernels' order (bit for bit where the stage has no live dense block) and
    against one dense product.  With ``mode`` (:func:`mode_kwargs`) the
    epilogue writes the mode's output: the row is the kernel the mode takes
    the place of (:func:`mode_row`), counted as ``stage_matmul`` launches at
    the mode's shape key, held to the dense product through the plain mode
    (on the dense input, :func:`stage_input`), timed beside the stage alone
    (``stage_ms``, the plain modes) and with no library call (none computes
    the stage and the mode in one)."""
    ds = device_stage(ps, dev)
    kw, key_mode = mode_kwargs(ps, batch, mode, dev)
    src, xin = stage_input(ps, kw, rng, batch, dev)
    y = stage_matmul(ps, xin, layer=layer, **kw)
    torch.cuda.synchronize()
    plain = stage_matmul_plain(ps, xin, layer=layer, **kw)
    err = check_close(label, y, plain, SUM_TOL)
    if exact and not torch.equal(y, plain):
        fail(f"{label}: kernel differs from the plain version on dyadic input")
    equal_to_plain = bool(torch.equal(y, plain))
    in_order = check_in_order(label, ps, xin, y, layer, **kw)
    bias = (torch.from_numpy(ps.bias[layer]).to(dev)
            if ps.bias is not None else None)
    if w is None:  # the stage's own linear map, column by column
        eye = torch.eye(ps.d_src, dtype=torch.float32, device=dev)
        w = stage_matmul_plain(replace(ps, bias=None), eye, layer=layer)
    library = ((lambda: torch.addmm(bias[:, None], w, src)) if bias is not None
               else (lambda: torch.matmul(w, src)))
    check_close(label + " vs dense", stage_matmul(ps, src, layer=layer),
                library(), 1e-4)
    extra = {}
    if kw:
        extra = dict(counted_as="stage_matmul", mode=key_mode[0],
                     equal_to_plain=equal_to_plain, dense_ms=timer(library),
                     stage_ms=timer(lambda: stage_matmul(ps, src, layer=layer)))
        library = None
    return kernel_row(
        mode_row(key_mode), label, stage_dims(ds, batch, layer),
        ds.shape_key(batch, 1, key_mode), err, exact or in_order,
        lambda: stage_matmul(ps, xin, layer=layer, **kw),
        lambda: stage_matmul_plain(ps, xin, layer=layer, **kw), library,
        bound_of(*mode_cost(ds, layer, batch, kw)), timer,
        live_terms=ds.live_terms[layer],
        run_terms=ds.maps[layer].run_terms if ds.maps else 0,
        segs=ps.segs is not None,
        live_bias=bool(ps.bias is not None and np.any(ps.bias[layer])),
        warm_l2_ms=timer(lambda: stage_matmul(ps, xin, layer=layer, **kw),
                         cold=False), **extra)


def check_in_order(label, ps, src, y, layer, **kw):
    """The kernel against :func:`ordered_stage_plain` (in the modes of
    ``kw``): bit for bit where the stage has no live dense block (then
    True), else within SUM_TOL."""
    ds = device_stage(ps, y.device)
    sm = torch.cuda.get_device_properties(y.device).multi_processor_count
    want = ordered_stage_plain(ps, src, layer, sm, **kw)
    if ds.fs_live[layer] or ds.dw_live[layer]:
        check_close(label + " in kernel order", y, want, SUM_TOL)
        return False
    if not torch.equal(y, want):
        err = float((y - want).abs().max())
        fail(f"{label}: kernel differs from the plain arithmetic in its own "
             f"order by {err:.3e}")
    return True


def handbuilt_stage(rng, *, p, s=4, r=4096, group=512, k_in=256, d_src=300,
                    dense=False):
    """A one-layer stage around raw CSD levels: level 0 reads the prep
    buffer, level >= 1 rows read rows of their own ``group`` (so the kernel
    gets several blocks); prep pairs share targets (weight sharing) and
    carry padding pairs into the dead row; with ``dense``, nonzero dyadic
    fs/dw blocks and a bias.  Exponents and inputs are small dyadic numbers,
    so every sum is exact."""
    idx = np.zeros((p, r, s), np.int64)
    idx[0] = rng.integers(0, k_in, (r, s))
    for q in range(1, p):
        idx[q] = (np.arange(r) // group * group)[:, None] + rng.integers(0, group, (r, s))
    exp = rng.integers(-2, 2, (p, r, s))
    sgn = rng.choice([-1, 0, 1, 1], (p, r, s))
    labels = np.concatenate([np.arange(k_in), rng.integers(0, k_in, d_src - k_in)])
    labels = labels[rng.permutation(d_src)]
    m = d_src + 5  # five padding pairs: source 0 into the dead row
    prep_src = np.zeros(m, np.int32)
    prep_src[:d_src] = np.arange(d_src)
    prep_tgt = np.full(m, k_in, np.int32)
    prep_tgt[:d_src] = labels
    out = r // 2  # every output row sums two rows of the last level
    outg = np.stack([np.arange(out), out + np.arange(out)]).astype(np.int32)
    outg[1, ::7] = r  # some entries read the zero row
    fs = dw = bias = None
    if dense:
        fs = (rng.integers(-4, 5, (1, out, k_in + 1)) / 8).astype(np.float32)
        fs[..., -1] = 0.0  # the dead row's column
        dw = (rng.integers(-4, 5, (1, out, d_src)) / 8).astype(np.float32)
        bias = (rng.integers(-8, 9, (1, out)) / 8).astype(np.float32)
    return ops.PackedStage(
        prep_src=prep_src[None], prep_tgt=prep_tgt[None],
        gidx=idx.astype(np.int32)[None], gexp=exp.astype(np.int8)[None],
        gsgn=sgn.astype(np.int8)[None], outg=outg[None], fs_mat=fs,
        dw_mat=dw, bias=bias, k_alloc=k_in + 1, d_src=d_src, out_dim=out,
        n_layers=1, site_names=("handbuilt",))


def reduced_stage_cases(red_plan, dev, timer):
    """K6 where the full-width path does not reach: hand-built exact stages
    (odd and even level counts, S = 4 and S = 3 slots a row, weight-shared
    prep with padding pairs, nonzero fs/dw/bias), the reduced plan's stages
    with and without ``segs``, and ragged batch widths."""
    rng = np.random.default_rng(30)
    rows = hand_stage_cases(rng, dev, timer)
    st = red_plan.stages
    for name in ("qkv", "o", "gu", "dn"):
        rows.append(kernel_case_stage(f"reduced {name}", st[name], rng, dev, timer))
    rows.append(kernel_case_stage("reduced qkv segs=None layer 1",
                                  replace(st["qkv"], segs=None), rng, dev,
                                  timer, layer=1))
    for batch in (1, 5, 13):  # a ragged last block of columns
        rows.append(kernel_case_stage(f"reduced gu B={batch}", st["gu"], rng,
                                      dev, timer, batch=batch))
    return rows


def main_path_stage_cases(art, plan, dev, timer):
    """K6 at exactly the dimensions the plan serve launches it at: layer 0
    of each of the full-width plan's four stages, B = n_slots, gate+up in
    its gated mode (K7's SwiGLU); the yardstick is one product with the
    stage's dense-effective matrix."""
    rng = np.random.default_rng(40)
    rows = []
    for name in ("qkv", "o", "gu", "dn"):
        rows.append(kernel_case_stage(f"full {name}", plan.stages[name], rng,
                                      dev, timer,
                                      w=stage_weights(art, name, 0, dev),
                                      mode=serve_mode(art.config, name)))
        torch.cuda.empty_cache()
    return rows


def serve_mode(cfg, name):
    """The modes the plan serves launch stage ``name`` in
    (:func:`mode_kwargs`): gate+up and the experts' gates+ups (K9's stage A)
    gated, the whole-step plan's experts' gates+ups also gathered; the
    whole-step plan's expert downs combining; others plain (K9's stage B
    too: its caller dispatches and combines, as in the reference)."""
    if name == "eg" and cfg.mla is None:
        return ("gather", cfg.moe.n_experts, BATCH, cfg.moe.top_k, "gated")
    if name in ("gu", "eg", "a"):
        return "gated"
    if name == "ed" and cfg.mla is None:
        return ("combine", cfg.moe.n_experts, BATCH, cfg.moe.top_k)
    return None


def hand_stage_cases(rng, dev, timer):
    """K6 on the hand-built exact stages (odd and even level counts, S = 4
    and S = 3 slots a row, weight-shared prep with padding pairs, output
    entries that read the zero row, nonzero fs/dw/bias, the gathered
    input): bit for bit."""
    return [kernel_case_stage("hand P=3", handbuilt_stage(rng, p=3), rng, dev,
                              timer, exact=True),
            kernel_case_stage("hand P=2 S=3", handbuilt_stage(rng, p=2, s=3),
                              rng, dev, timer, exact=True),
            kernel_case_stage("hand P=3 fs+dw+bias",
                              handbuilt_stage(rng, p=3, dense=True), rng, dev,
                              timer, exact=True),
            # the gathered input read by the prep and by the live dw block:
            # 300 inputs as 4 experts of 75, 8 tokens top-2, cap 8
            kernel_case_stage("hand P=3 fs+dw+bias gathered",
                              handbuilt_stage(rng, p=3, dense=True), rng, dev,
                              timer, exact=True,
                              mode=("gather", 4, BATCH, 2, None))]


STAGE_ARCHS = ("olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b",
               "qwen2.5-3b", "llama3.2-3b", "yi-9b")


def main_path_stages(dev, archs=STAGE_ARCHS):
    """The K6 launches of the six float32 plan routes, one architecture
    at a time: yields ``(arch, host times, [(label, name, stage, batch)],
    artifact)`` — olmo-1b, qwen2.5-3b, llama3.2-3b and yi-9b qkv/o/gu/dn and
    mixtral-8x22b qkv/o at B = n_slots, mixtral eg/ed and
    deepseek-v2-lite-16b's K9 stages A and B at B = capacity — each from
    layer 0 of a one-layer seeded artifact of the
    full-width config (widths never cut), packed and uploaded as the serves
    do.  ``name`` is the stage's kind: qkv/o/gu/dn/eg/ed."""
    for arch in archs:
        cfg = replace(get_arch(arch), n_layers=1, param_dtype="float32",
                      compute_dtype="float32")
        t = time.perf_counter()
        art = seeded_artifact(cfg, seed=2, device=dev, host_effective=False)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t
        ex = CompressedExecutor(art, device=dev)
        if cfg.mla is not None:
            plan = ex.moe_plan("l0", n_experts=cfg.moe.n_experts,
                               d_model=cfg.d_model, d_ff=cfg.moe.d_ff_expert)
        else:
            plan = ex.step_plan(cfg)
        t = time.perf_counter()
        for ps in plan.stages.values():
            device_stage(ps, dev)  # validation, tables, upload
        torch.cuda.synchronize()
        host = dict(arch=arch, draw_s=draw_s, pack_s=plan.pack_s,
                    upload_s=time.perf_counter() - t,
                    host_peak_rss_bytes=host_peak_rss_bytes())
        short = arch.split("-")[0]
        cap = (capacity(BATCH, cfg.moe.top_k, cfg.moe.capacity_factor,
                        cfg.moe.n_experts) if cfg.moe is not None else BATCH)
        cases = []
        for name, ps in plan.stages.items():
            if cfg.mla is not None:  # K9: stage A (gates, ups), B (downs)
                cases.append((f"{short} K9 stage {name.upper()}",
                              "eg" if name == "a" else "ed", ps, cap))
            elif name in ("eg", "ed"):
                cases.append((f"{short} {name}", name, ps, cap))
            else:
                cases.append((f"{short} {name}", name, ps, BATCH))
        del ex, plan
        yield arch, host, cases, art
        del art, cases
        gc.collect()
        torch.cuda.empty_cache()


def phase_stage(dev):
    """``--only stage``: K6 alone at the 22 shapes the six float32 plan
    routes launch it at (:func:`main_path_stages`), each in the modes the
    serve launches it in (:func:`serve_mode`), plus the hand-built exact
    stages.  No serve.  Each case as in the kernel phase: against the plain
    version, in the kernels' order, against the dense product, timed beside
    its bound, the plain version and one library call (or, in a mode, the
    stage alone)."""
    t0 = time.perf_counter()
    timer = Timer(dev)
    rows = hand_stage_cases(np.random.default_rng(30), dev, timer)
    hosts = []
    for arch, host, cases, art in main_path_stages(dev):
        hosts.append(host)
        emit(dict(phase="stage_arch", **host))
        rng = np.random.default_rng(40)
        cfg = get_arch(arch)
        for label, name, ps, batch in cases:
            mode = serve_mode(cfg, name)
            if name in ("eg", "ed"):
                rows.append(kernel_case_expert_stage(
                    label, name, art, ps, dev, timer, batch=batch, serve=None,
                    mode=mode))
            else:
                rows.append(kernel_case_stage(
                    label, ps, rng, dev, timer,
                    w=stage_weights(art, name, 0, dev), mode=mode))
            gc.collect()
            torch.cuda.empty_cache()
    return dict(phase="stage", seconds=time.perf_counter() - t0,
                tolerance=SUM_TOL, hosts=hosts, rows=rows)


def step_inputs(cfg, plan, rng, dev, *, batch=BATCH, smax=MAX_LEN,
                paged=True, norm=None, window=None):
    """Arguments of one decode step: random hidden states and caches, every
    row at its own position with the slots before it filled, row 1 idle."""
    n_l, d, nkv, hd = cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.hd
    f32 = dict(dtype=torch.float32, device=dev)
    pos_np = rng.integers(1, smax, batch).astype(np.int32)
    pos_np[1] = -1
    kpos_np = np.where(np.arange(smax)[None, None, :] < pos_np[None, :, None],
                       np.arange(smax)[None, None, :], -1)
    kpos_np = np.ascontiguousarray(np.broadcast_to(kpos_np, (n_l, batch, smax)),
                                   dtype=np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    sin, cos = _rope_sincos(pos, hd, cfg.rope_theta)
    norm = norm or cfg.norm
    args = dict(n_heads=cfg.n_heads, n_kv_heads=nkv, head_dim=hd, d_ff=cfg.d_ff,
                norm=norm, rope=cfg.pos == "rope", x0=torch.randn((d, batch), **f32),
                pos=pos, cos=cos, sin=sin, kpos=torch.from_numpy(kpos_np).to(dev),
                window=window, ln1=None, ln2=None)
    if norm == "rms":
        args["ln1"] = 1.0 + 0.1 * torch.randn((n_l, d), **f32)
        args["ln2"] = 1.0 + 0.1 * torch.randn((n_l, d), **f32)
    if paged:
        bs = 16
        mb = smax // bs
        args["kc"] = torch.randn((n_l, batch * mb + 1, bs, nkv, hd), **f32)
        args["vc"] = torch.randn((n_l, batch * mb + 1, bs, nkv, hd), **f32)
        args["block_tbl"] = torch.from_numpy(
            (1 + rng.permutation(batch * mb)).reshape(batch, mb)
            .astype(np.int32)).to(dev)
    else:
        args["kc"] = torch.randn((n_l, batch, smax, nkv, hd), **f32)
        args["vc"] = torch.randn((n_l, batch, smax, nkv, hd), **f32)
    return args


def kernel_case_step(label, cfg, plan, rng, dev, timer, serve=None, **kw):
    """``step_plan_matmul`` on one decode step, held against its plain
    version: the final hidden state and every layer's new K/V rows.  An MoE
    plan routes every layer's FFN inside the step (K8); the kernel and its
    plain version each count their dropped choices, which must agree."""
    torch.manual_seed(int(rng.integers(1 << 31)))
    args = step_inputs(cfg, plan, rng, dev, **kw)
    n_l, b, smax = cfg.n_layers, args["x0"].shape[1], args["kpos"].shape[2]
    nq, nkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    cap = b
    moe = moe_plain = None
    if plan.moe is not None:
        moe = dict(plan.moe, dropped=torch.zeros(1, dtype=torch.int32, device=dev))
        moe_plain = dict(moe, dropped=torch.zeros(1, dtype=torch.int32, device=dev))
        cap = capacity(b, cfg.moe.top_k, cfg.moe.capacity_factor,
                       cfg.moe.n_experts)
    y, kn, vn = step_plan_matmul(plan.stages, **args, moe=moe)
    torch.cuda.synchronize()
    want = step_plan_matmul_plain(plan.stages, **args, moe=moe_plain)
    err = max(check_close(f"{label} {part}", got, ref, STEP_TOL)
              for part, got, ref in zip(("y", "k_new", "v_new"), (y, kn, vn), want))
    drops = None
    if moe is not None:
        drops = int(moe["dropped"])
        if drops != int(moe_plain["dropped"]):
            fail(f"{label}: {drops} dropped choices in the kernels, "
                 f"{int(moe_plain['dropped'])} in the plain version")
        torch.cuda.empty_cache()
    bytes_ = flops = 0
    for name, ps in plan.stages.items():
        sb, sf = stage_cost(device_stage(ps, dev), range(n_l),
                            cap if name in ("eg", "ed") else b)
        bytes_ += sb
        flops += sf
    if moe is not None:  # K8: router, expert input and output, once a layer
        n_exp = cfg.moe.n_experts
        bytes_ += n_l * 4 * (d * n_exp + 2 * n_exp * d * cap)
        flops += n_l * 2 * d * b * n_exp
    # every layer: the K/V rows its data needs (live_rows) and all of kpos
    # read once, the new rows out; the hidden state in and out
    rows_kv, rows_v = live_rows(dict(pos=args["pos"], kpos=args["kpos"][0],
                                     window=args["window"]))
    bytes_ += n_l * ((2 * rows_kv + rows_v) * nkv * hd * 4 + b * smax * 4
                     + 2 * b * nkv * hd * 4)
    bytes_ += 2 * 4 * d * b
    flops += n_l * (4 * nq * hd * rows_kv + nq * hd * rows_v)
    key = (n_l, d, cfg.d_ff, b, smax, nq, nkv, hd)
    return kernel_row(
        "step_plan_matmul", label,
        dict(L=n_l, d=d, d_ff=cfg.d_ff, B=b, S=smax, Hq=nq, Hkv=nkv, hd=hd,
             norm=args["norm"], window=args["window"],
             paged=args.get("block_tbl") is not None,
             moe=moe is not None, cap=cap if moe is not None else None,
             dropped=drops),
        key, err, False, lambda: step_plan_matmul(plan.stages, **args, moe=moe),
        lambda: step_plan_matmul_plain(plan.stages, **args, moe=moe_plain),
        None, bound_of(bytes_, flops), timer, serve=serve)


# ----------------------------------- K7's attention and K8's route alone

# the long caches of --only attention: olmo-1b's published context
# (arXiv:2402.00838) and mixtral-8x22b's window (configs/mixtral_8x22b.py)
LONG_CACHE = {"olmo-1b": 2048, "mixtral-8x22b": 4096}
PAGE = 16  # the serves' kv_block


def serve_positions(rng, batch=BATCH):
    """Decode positions as the plan serves have them: 6 prompts of 8 tokens
    with up to 16 new ones on 8 slots, the last two slots idle."""
    pos = np.full(batch, -1, np.int32)
    live = min(6, batch)
    pos[:live] = 8 + rng.integers(0, 16, live)
    return pos


def attention_inputs(cfg, smax, window, pos, rng, dev, *, bs=PAGE):
    """One layer's arguments of ``step_attention`` at ``cfg``'s heads: a
    random qkv stage output, rows at ``pos`` (-1: idle), each active row's
    cache holding the positions before it (under a window the last ``smax``
    of them, in a ring), random K/V rows in a shuffled pool of pages of
    ``bs`` slots."""
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b = len(pos)
    pos_np = np.asarray(pos, np.int32)
    kpos = np.full((b, smax), -1, np.int32)
    for r, p in enumerate(pos_np):
        if p >= 0:
            ps = np.arange(max(0, p - smax), p) if window else np.arange(min(p, smax))
            kpos[r, ps % smax] = ps
    f32 = dict(dtype=torch.float32, device=dev)
    mb = smax // bs
    pos_t = torch.from_numpy(pos_np).to(dev)
    sin, cos = _rope_sincos(pos_t, hd, cfg.rope_theta)
    return dict(
        qkv=torch.randn(((nq + 2 * nkv) * hd, b), **f32), pos=pos_t, cos=cos,
        sin=sin, kc=torch.randn((b * mb + 1, bs, nkv, hd), **f32),
        vc=torch.randn((b * mb + 1, bs, nkv, hd), **f32),
        kpos=torch.from_numpy(kpos).to(dev),
        block_tbl=torch.from_numpy((1 + rng.permutation(b * mb)).reshape(b, mb)
                                   .astype(np.int32)).to(dev),
        n_heads=nq, n_kv_heads=nkv, head_dim=hd, window=window)


def _attention_view(a):
    """``(q [B, Hkv, G, hd] rotated, k_new, v_new [B, Hkv, hd], K, V [B, S,
    Hkv, hd] with the new rows in the hit slots, logits [B, Hkv, G, S],
    valid, hit [B, S])`` of one layer, as the plain version computes them."""
    qkv = a["qkv"]
    nq, nkv, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    b = qkv.shape[1]
    kc, vc = a["kc"], a["vc"]
    if a.get("block_tbl") is not None:
        tbl = a["block_tbl"].long()
        kc = kc[tbl].reshape(b, -1, *kc.shape[2:])
        vc = vc[tbl].reshape(b, -1, *vc.shape[2:])
    qb = qkv[: nq * hd].reshape(nq, hd, b).permute(2, 0, 1)
    kb = qkv[nq * hd: (nq + nkv) * hd].reshape(nkv, hd, b).permute(2, 0, 1)
    vb = qkv[(nq + nkv) * hd:].reshape(nkv, hd, b).permute(2, 0, 1)
    if a["cos"] is not None:
        c, s = a["cos"][:, None, :], a["sin"][:, None, :]
        qb, kb = _rot(qb, c, s, hd // 2), _rot(kb, c, s, hd // 2)
    valid, hit = _valid_hit(a)
    hk = hit[:, :, None, None]
    kx = torch.where(hk, kb[:, None], kc)
    vx = torch.where(hk, vb[:, None], vc)
    qg = qb.reshape(b, nkv, nq // nkv, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=qkv.device))
    zero = torch.zeros((), device=qkv.device)
    logits = (torch.einsum("bhgd,bshd->bhgs", qg, kx) * scale
              + torch.where(valid, zero, zero - 1e30)[:, None, None, :])
    return qg, kb, vb, kx, vx, logits, valid, hit


def ordered_attention_plain(a, plan):
    """``step_attention``'s output in the kernel's order of operations, in
    PyTorch: each split of ``plan`` takes its chunk's live slots only (every
    slot for a row none of whose slots must be live: an idle row), its max,
    sum and PV sum; the splits merge in order (an empty one adds nothing)."""
    _, _, _, _, vx, logits, valid, hit = _attention_view(a)
    pos, window = a["pos"].long(), a["window"]
    b, smax = valid.shape
    full = (pos < 0) | ((pos >= smax) & (window is None))
    live = valid | hit | full[:, None]
    ninf = torch.tensor(float("-inf"), device=vx.device)
    parts = []
    for sp in range(plan.splits):
        c0, c1 = sp * plan.chunk, min(smax, (sp + 1) * plan.chunk)
        lv = live[:, None, None, c0:c1]
        lg = torch.where(lv, logits[..., c0:c1], ninf)
        m = lg.amax(-1)
        e = torch.where(lv, torch.exp(lg - m[..., None]), torch.zeros_like(lg))
        parts.append((m, e.sum(-1), torch.einsum("bhgs,bshd->bhgd", e, vx[:, c0:c1])))
    big = torch.stack([torch.where(l > 0, m, ninf) for m, l, _ in parts]).amax(0)
    den, num = 0.0, 0.0
    for m, l, o in parts:
        f = torch.where(l > 0, torch.exp(m - big), torch.zeros_like(m))
        den = den + l * f
        num = num + o * f[..., None]
    att = num / den[..., None]
    return att.reshape(b, -1).T


def live_rows(a):
    """``(K and V rows, V rows)`` of one layer that the data needs: an active
    row needs the K and V rows of its valid slots (the hit slot's are the
    new ones); a row with none (an idle row) the mean of all S V rows."""
    valid, hit = _valid_hit(a)
    need = (valid & ~hit).sum(1)
    uniform = ~valid.any(1)
    return int(need[~uniform].sum()), int(uniform.sum()) * valid.shape[1]


def _valid_hit(a):
    """``(valid, hit)`` ``[B, S]`` of one layer: the reference's mask and
    the current token's slot."""
    pos, kp, window = a["pos"].long(), a["kpos"].long(), a["window"]
    smax = kp.shape[1]
    slot = (torch.where(pos >= 0, pos % smax, torch.full_like(pos, -1))
            if window is not None else pos)
    hit = torch.arange(smax, device=pos.device)[None, :] == slot[:, None]
    ok = (kp >= 0) & (kp <= pos[:, None])
    if window is not None:
        ok = ok & (kp > pos[:, None] - window)
    return torch.where(hit, (pos >= 0)[:, None], ok), hit


def attention_cost(a, rows_kv, rows_v):
    """(bytes, operations) of one layer's attention: the needed K/V rows, all
    of kpos, the block table, q/k/v and the rope tables in, att and the new
    K/V rows out; 4 * G * hd operations a (kv-head, needed K/V row)."""
    b, smax = a["kpos"].shape
    nq, nkv, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    row = nkv * hd * 4
    tbl = a.get("block_tbl")
    bytes_ = ((2 * rows_kv + rows_v) * row + 4 * b * smax
              + (0 if tbl is None else 4 * tbl.numel()) + 4 * b
              + 4 * b * hd + 4 * (nq + 2 * nkv) * hd * b
              + 4 * nq * hd * b + 2 * 4 * nkv * hd * b)
    return bytes_, 4 * nq * hd * rows_kv + nq * hd * rows_v


def sdpa_inputs(a):
    """One ``scaled_dot_product_attention`` call's inputs for the same
    function: rotated q ``[B, Hq, 1, hd]``, K and V ``[B, Hq, S, hd]``
    contiguous with the new rows in the hit slots and the kv-heads expanded
    to the query heads (outside the timed region), the additive mask
    ``[B, 1, 1, S]``."""
    qg, _, _, kx, vx, _, valid, _ = _attention_view(a)
    b, nkv, g, hd = qg.shape
    q = qg.reshape(b, nkv * g, 1, hd).contiguous()
    kx = kx.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    vx = vx.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    zero = torch.zeros((), device=q.device)
    mask = torch.where(valid, zero, zero - 1e30)[:, None, None, :].contiguous()
    return q, kx, vx, mask


def kernel_case_attention(label, cfg, smax, window, pos, dev, timer, *,
                          serve=None):
    """K7's attention (``step_attention``) on one layer at ``cfg``'s heads,
    paged as the serves are: against its plain version (within SUM_TOL: the
    softmax and both sums in other orders), bitwise from run to run, and
    against the plain arithmetic in the kernel's order
    (:func:`ordered_attention_plain`, reported).  Timed beside the bound
    (what the data needs: :func:`live_rows`) and one
    ``scaled_dot_product_attention`` call on the same function
    (:func:`sdpa_inputs`; its deviation reported), which the port never
    calls.  Inputs are seeded by ``label``: the same in any process."""
    seed = zlib.crc32(label.encode())
    torch.manual_seed(seed)
    a = attention_inputs(cfg, smax, window, pos, np.random.default_rng(seed), dev)
    got = step_attention(**a)
    again = step_attention(**a)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"{label}: the attention is not bitwise identical run to run")
    want = step_attention_plain(**a)
    err = max(check_close(f"{label} {part}", x, y, SUM_TOL)
              for part, x, y in zip(("att", "k_new", "v_new"), got, want))
    b, nq, nkv, hd = len(pos), cfg.n_heads, cfg.n_kv_heads, cfg.hd
    plan = plan_attention(b, nkv, nq // nkv, smax,
                          torch.cuda.get_device_properties(dev).multi_processor_count,
                          PAGE, head_dim=hd)
    ordered = ordered_attention_plain(a, plan)
    q, kx, vx, mask = sdpa_inputs(a)
    lib_out = F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask)
    rows_kv, rows_v = live_rows(a)
    scale = max(1.0, float(want[0].abs().max()))
    dims = dict(B=b, S=smax, Hq=nq, Hkv=nkv, hd=hd, page=PAGE, window=window,
                idle_rows=int((a["pos"] < 0).sum()), kv_rows=rows_kv,
                v_rows=rows_v, splits=plan.splits, chunk=plan.chunk,
                blocks=plan.splits * nkv * b)
    return kernel_row(
        "step_attention", label, dims,
        attention_key(b, smax, nq, nkv, hd, PAGE, window), err, False,
        lambda: step_attention(**a), lambda: step_attention_plain(**a),
        lambda: F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask),
        bound_of(*attention_cost(a, rows_kv, rows_v)), timer, serve=serve,
        bitwise_run_to_run=True,
        err_vs_ordered=float((got[0] - ordered).abs().max()) / scale,
        library_err=float((lib_out.reshape(b, nq * hd).T - want[0]).abs().max())
        / scale, library_call="scaled_dot_product_attention, kv-heads expanded")


def attention_cases(rng):
    """``(label, arch config, S, window, positions)`` of every ``--only
    attention`` case: each plan serve's shape (S = 128, paged, the serves'
    positions, two idle rows), and each model's long cache twice, at random
    positions (row 1 idle) and full."""
    for arch in ("olmo-1b", "mixtral-8x22b"):
        cfg = get_arch(arch)
        w, s = cfg.attn_window, LONG_CACHE[arch]
        yield f"{arch} serve S={MAX_LEN}", cfg, MAX_LEN, w, serve_positions(rng)
        pos = rng.integers(1, 2 * s if w else s, BATCH).astype(np.int32)
        pos[1] = -1
        yield f"{arch} S={s} random", cfg, s, w, pos
        pos = (rng.integers(s, 2 * s, BATCH) if w else np.full(BATCH, s - 1))
        yield f"{arch} S={s} full", cfg, s, w, pos.astype(np.int32)


def ordered_norm_plain(x, w, norm, plan):
    """K7's norm in the kernel's own order, in PyTorch operations (``plan``:
    its :func:`plan_norm` geometry).  Each column's sums: in every block of
    the cluster, thread partials over its rows s, s + S, ... in ascending
    order (S = threads / cols), a butterfly over the lanes of a warp that
    hold the column, then the warps in order; then the blocks in rank
    order.  The mean and 1/sd as the kernel takes them."""
    d, b = x.shape
    cols, threads, rows = plan.cols, plan.threads, plan.rows
    slots, warps, lanes = threads // cols, threads // 32, 32 // cols
    bp = plan.groups * cols
    f32 = dict(dtype=torch.float32, device=x.device)
    xp = torch.zeros((d, bp), **f32)
    xp[:, :b] = x  # the tile's columns past B are zeros

    def column_sums(v):
        tot = torch.zeros(bp, **f32)
        for q in range(plan.split):
            vb = v[q * rows:(q + 1) * rows]
            # zero rows up to a whole number of slots leave each sum as it is
            vp = torch.zeros((-(-vb.shape[0] // slots) * slots, bp), **f32)
            vp[:vb.shape[0]] = vb
            part = torch.zeros((slots, bp), **f32)
            for k in range(vp.shape[0] // slots):
                part = part + vp[k * slots:(k + 1) * slots]
            a = part.reshape(warps, lanes, bp)
            h = lanes // 2
            while h >= 1:  # lane 0's butterfly partners, halving
                a = a[:, :h] + a[:, h:2 * h]
                h //= 2
            block = torch.zeros(bp, **f32)
            for wv in range(warps):
                block = block + a[wv, 0]
            tot = tot + block
        return tot

    fd = torch.tensor(float(d), **f32)
    if norm == "rms":
        mu, eps = torch.zeros(bp, **f32), 1e-6
        var = column_sums(xp * xp) / fd
    else:
        mu, eps = column_sums(xp) / fd, 1e-5
        c = xp - mu
        var = column_sums(c * c) / fd
    r = 1.0 / torch.sqrt(var + torch.tensor(eps, **f32))
    out = (xp - mu) * r
    if w is not None:
        out = out * w[:, None]
    return out[:, :b]


def kernel_case_norm(cfg, dev, timer, *, serve=None, plan=None, label=None,
                     batch=BATCH):
    """K7's norm (``step_norm``) alone at ``cfg``'s plan-serve shape ``[d,
    n_slots]`` (``plan``: the same launch at another geometry than the
    planner's, a ``norm_geometry``): against its plain version (SUM_TOL) and
    :func:`ordered_norm_plain` (SUM_TOL, and whether bit for bit), bitwise
    from run to run.  Library:
    ``F.rms_norm`` / ``F.layer_norm`` on the ``[B, d]`` transpose laid out
    beforehand."""
    torch.manual_seed(zlib.crc32(cfg.name.encode()))
    d, b = cfg.d_model, batch
    x = torch.randn((d, b), device=dev)
    xt = x.T.contiguous()
    rms = cfg.norm == "rms"
    w = 1.0 + 0.1 * torch.randn(d, device=dev) if rms else None
    eps = 1e-6 if rms else 1e-5
    chosen = plan is None
    plan = plan_norm(d, b) if chosen else plan
    label = label or f"{cfg.name} norm"

    def kernel():
        if chosen:
            return step_norm(x, w, cfg.norm)
        # another geometry: the wrapper's launch at that plan
        return _norm_launch(build.load(), torch.cuda.current_stream().cuda_stream,
                            x, None if w is None else w.data_ptr(), plan,
                            0 if rms else 1, eps)

    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"{label}: the norm differs from run to run")
    ordered = ordered_norm_plain(x, w, cfg.norm, plan)
    order_err = check_close(f"{label} (kernel order)", got, ordered, SUM_TOL)

    def library():
        return (F.rms_norm(xt, (d,), w, eps) if rms
                else F.layer_norm(xt, (d,), eps=eps))

    return kernel_row(
        "step_norm", label,
        dict(d=d, B=b, norm=cfg.norm, cols=plan.cols, groups=plan.groups,
             split=plan.split, rows=plan.rows, threads=plan.threads),
        (d, b), check_close(label, got, step_norm_plain(x, w, cfg.norm),
                            SUM_TOL),
        torch.equal(got, ordered), kernel,
        lambda: step_norm_plain(x, w, cfg.norm), library,
        bound_of(4 * (2 * d * b + (d if rms else 0)), 6 * d * b), timer,
        serve=serve, max_abs_err_kernel_order=order_err,
        # in the step the norm reads a hidden state the last stage just wrote
        warm_l2_ms=timer(kernel, cold=False))


def route_case_inputs(dev):
    """mixtral-8x22b's route at the plan serve's shape: its config and a
    random router scaled as an initialised one, seeded."""
    cfg = get_arch("mixtral-8x22b")
    torch.manual_seed(90)
    return cfg, torch.randn((cfg.d_model, cfg.moe.n_experts), device=dev) \
        * cfg.d_model ** -0.5


def phase_attention(dev):
    """``--only attention``: K7's attention alone at every case of
    :func:`attention_cases` and K8's route alone at mixtral's width (two
    idle columns, as the serve has), with no fixture and no serve."""
    t0 = time.perf_counter()
    timer = Timer(dev)
    rows = []
    for label, cfg, smax, window, pos in attention_cases(np.random.default_rng(60)):
        rows.append(kernel_case_attention(label, cfg, smax, window, pos, dev, timer))
        torch.cuda.empty_cache()
    cfg, router = route_case_inputs(dev)
    rows.append(kernel_case_moe("mixtral route", cfg, router, dev, timer,
                                idle=2)[0])
    return dict(phase="attention", seconds=time.perf_counter() - t0,
                tolerance=SUM_TOL, rows=rows)


# the per-region serves (--only chain times their K1/K2 shapes too) and the
# plan serves
PREP_ARCHS = ("olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b",
              "qwen2.5-3b", "llama3.2-3b", "yi-9b", "qwen2-vl-7b",
              "rwkv6-1.6b", "zamba2-7b", "whisper-small")
NORM_ARCHS = ("olmo-1b", "mixtral-8x22b", "qwen2.5-3b", "llama3.2-3b", "yi-9b")


def phase_prep(dev):
    """``--only prep``: K3's region prep alone at every region the ten
    per-region serves prepare (:func:`region_preps`: members drawn as the
    fixture draws them, no fixture, no serve; bf16 inputs, and float32 for
    deepseek's MLA and shared experts as its K9 serve passes them and for
    qwen2-vl's float32 engine), then K7's norm alone at the five plan
    serves' shapes
    (``tools/norm_sweep.py`` times it at every other geometry)."""
    t0 = time.perf_counter()
    timer = Timer(dev)
    rows = []
    for arch in PREP_ARCHS:
        cfg = get_arch(arch)
        rows += region_cases(cfg, dev, timer)
        if cfg.mla is not None:
            rows += [dict(r, k9=True) for r in region_cases(
                cfg, dev, timer, dtype=torch.float32,
                keep=lambda n: not n[0].startswith(ROUTED))]
        elif cfg.pos == "mrope" or cfg.family in ("ssm", "hybrid", "audio"):
            # their float32 engines serve per-region too
            rows += [dict(r, f32_engine=True) for r in region_cases(
                cfg, dev, timer, dtype=torch.float32)]
    for arch in NORM_ARCHS:
        rows.append(kernel_case_norm(get_arch(arch), dev, timer))
    return dict(phase="prep", seconds=time.perf_counter() - t0,
                tolerance=SUM_TOL, rows=rows)


def phase_kernels(dev, art, plan, red_cfg):
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = reduced_kernel_cases(red_cfg, dev, timer, sm)
    torch.cuda.empty_cache()
    rows += main_path_kernel_cases(art, dev, timer, sm)
    torch.cuda.empty_cache()
    red_art = seeded_artifact(red_cfg, seed=1, device=dev)
    red_plan = CompressedExecutor(red_art, device=dev).step_plan(red_cfg)
    rows += reduced_stage_cases(red_plan, dev, timer)
    rows += main_path_stage_cases(art, plan, dev, timer)
    gqa_cfg = replace(red_cfg, n_kv_heads=2)
    gqa_plan = CompressedExecutor(seeded_artifact(gqa_cfg, seed=3, device=dev),
                                  device=dev).step_plan(gqa_cfg)
    rng = np.random.default_rng(50)
    rows.append(kernel_case_step("reduced GQA contiguous rms window=5", gqa_cfg,
                                 gqa_plan, rng, dev, timer, paged=False,
                                 norm="rms", window=5))
    rows.append(kernel_case_step("reduced GQA paged", gqa_cfg, gqa_plan, rng,
                                 dev, timer))
    rows.append(kernel_case_step("full step", art.config, plan, rng, dev, timer))
    rows.append(kernel_case_norm(art.config, dev, timer, label="full norm"))
    rows.append(kernel_case_attention(
        "full attention", art.config, MAX_LEN, art.config.attn_window,
        serve_positions(rng), dev, timer))
    torch.cuda.empty_cache()
    # the whole step at olmo-1b's published context, every row's cache
    # filled to its position (K/V about 4.3 GB at 16 layers)
    s = LONG_CACHE["olmo-1b"]
    rows.append(kernel_case_step(f"long-cache step S={s}", art.config, plan,
                                 rng, dev, timer, smax=s))
    torch.cuda.empty_cache()
    arch = art.config.name
    for row in rows:  # the main-path rows: the serve whose shapes they check
        if row["shape"].startswith("full"):
            row["serve"] = f"{arch} " + ("per-region" if row["name"] in PER_REGION
                                         else "plan")
    return rows


# --------------------------------------------------------- phases 3 and 4


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def prompts_for(cfg, n):
    lm = MarkovLM(vocab=cfg.vocab, k=8, seed=0)
    return [lm.sample(1, 8, seed=100 + i)[0, :8].tolist() for i in range(n)]


def global_launches() -> float:
    """The process-wide ``kernel_launches_total`` counter (0 before the
    first launch creates it)."""
    c = get_global().get("kernel_launches_total")
    return 0.0 if c is None else c.value


def metric(eng, name, **labels) -> float:
    return eng.metrics.get(name).get(**labels)


def serve(art, device, *, use_kernel, n_slots, prompts, max_new,
          max_len=MAX_LEN, setup=None, mesh=None):
    """The serves' 8-token prompts through ``Scheduler`` + ``ServingEngine``
    (the prefix cache on, its default): they fill no 16-token block, so
    nothing is registered and no request may find cached tokens.  The
    engine's default telemetry (a registry of its own, the step profiler)
    is on, and must have counted what the serve saw: the steps it timed,
    the tokens it returned, the launches of the newest step under its
    bucket, and every launch in the process-wide counter.  ``setup(eng)``
    runs on the new engine before the first request (whisper's cross-KV);
    ``mesh`` serves over a device mesh."""
    eng = ServingEngine(artifact=art, n_slots=n_slots, max_len=max_len,
                        use_kernel=use_kernel, kv_block=16, device=device,
                        mesh=mesh)
    if setup is not None:
        setup(eng)
    sched = Scheduler(eng)
    rids = [sched.enqueue(p, max_new=max_new) for p in prompts]
    step_s = []
    n0, g0 = dispatch.launch_count(), global_launches()
    while sched.pending or sched.inflight or eng.active.any():
        t0 = time.perf_counter()
        sched.step()  # ends in the step's device->host copy: host time is right
        step_s.append(time.perf_counter() - t0)
    res = [sched.take_result(r) for r in rids]
    cached = [r.stats.get("cached_tokens", 0) for r in res]
    if any(cached) or eng.pool_stats()["prefix_hit_tokens"]:
        fail(f"serve: requests found cached tokens {cached}; these prompts "
             "fill no block")
    seen = dict(
        decode_steps=(metric(eng, "serving_decode_steps_total"), len(step_s)),
        tokens=(metric(eng, "serving_tokens_total"),
                sum(len(r.tokens) - r.prompt_len for r in res)),
        launches_per_step=(metric(eng, "serving_kernel_launches_per_step",
                                  bucket=f"{n_slots}x1"),
                           eng.kernel_launches_per_step),
        launches=(global_launches() - g0, dispatch.launch_count() - n0),
        profiled_steps=(eng.profiler.total_steps, len(step_s)))
    if any(got != want for got, want in seen.values()):
        fail(f"serve: telemetry (got, saw) disagree: {seen}")
    return eng, res, step_s


def serve_telemetry(eng) -> dict:
    """A serve's telemetry for its line, read before anything else steps
    the engine: the step profiler's summary and the registry's counts."""
    return dict(profiler=eng.profiler.summary(),
                decode_steps=metric(eng, "serving_decode_steps_total"),
                tokens=metric(eng, "serving_tokens_total"),
                launches_per_step=metric(
                    eng, "serving_kernel_launches_per_step",
                    bucket=f"{eng.n_slots}x1"))


def phase_reduced_serve(dev, cfg, *, n_slots=4, n_prompts=3):
    """The reduced config on the plan route (kernels), its plain version on
    the CPU and the dense-effective weights: the same greedy tokens, one
    step's logits within 1e-4; for MoE the same dropped choices (some)."""
    art = seeded_artifact(cfg, seed=1, device=dev)
    art_cpu = replace(art, params=to_device(art.params, "cpu"))
    prompts = prompts_for(cfg, n_prompts)
    dispatch.reset_launch_count()
    eng_k, res_k, _ = serve(art, dev, use_kernel=True, n_slots=n_slots,
                            prompts=prompts, max_new=8)
    counts = dispatch.launch_counts()
    eng_p, res_p, _ = serve(art_cpu, "cpu", use_kernel=True, n_slots=n_slots,
                            prompts=prompts, max_new=8)
    _, res_d, _ = serve(art, dev, use_kernel=False, n_slots=n_slots,
                        prompts=prompts, max_new=8)
    for r in res_k + res_p + res_d:
        if r.error or not r.finished:
            fail(f"reduced serve: request failed: {r.error}")
    if not ([r.tokens for r in res_k] == [r.tokens for r in res_p]
            == [r.tokens for r in res_d]):
        fail("reduced serve: greedy tokens differ between kernel, plain and "
             "dense-effective routes")
    drops = None
    if cfg.moe is not None:
        drops = [int(e.executor.moe_dropped) for e in (eng_k, eng_p)]
        if drops[0] != drops[1] or drops[0] <= 0:
            fail(f"reduced serve: dropped choices kernel/plain {drops}: they "
                 "must agree and some must occur")
    # one decode step, logits of the three routes
    tok = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (n_slots, 1))).to(dev)
    pos = torch.zeros(n_slots, dtype=torch.long, device=dev)

    def logits(a, device, executor):
        st = api.init_decode_state(cfg, n_slots, 16, device=device)
        with torch.no_grad():
            lg, _ = api.decode(a.params, cfg, st, tok.to(device), pos.to(device),
                               executor=executor)
        return lg.float().cpu()

    # the reduced config computes in float32: its default route is the plan
    l_k = logits(art, dev, CompressedExecutor(art, device=dev))
    l_r = logits(art, dev, CompressedExecutor(art, use_plans=False, device=dev))
    l_p = logits(art_cpu, "cpu", CompressedExecutor(art_cpu, device="cpu"))
    l_d = logits(art, dev, None)
    errs = dict(kernel_vs_plain=float((l_k - l_p).abs().max()),
                kernel_vs_dense=float((l_k - l_d).abs().max()),
                plan_vs_per_region=float((l_k - l_r).abs().max()))
    if max(errs.values()) > 1e-4 or not bool(torch.isfinite(l_k).all()):
        fail(f"reduced serve: logits disagree: {errs}")
    if eng_k.executor.routed != eng_k.executor.sites:
        fail("reduced serve: not every site was routed through a kernel")
    # MLA refuses the whole-step plan: one expert plan (K9) a layer instead
    n_plans = cfg.n_layers if cfg.mla is not None else 1
    if eng_k.n_layer_plans != n_plans:
        fail(f"reduced serve: {eng_k.n_layer_plans} layer plans, expected "
             f"{n_plans}")
    return dict(phase="reduced_serve", arch=cfg.name, logits_max_abs_err=errs,
                tol=1e-4, tokens_equal=True, launches=counts,
                launches_per_step=eng_k.kernel_launches_per_step,
                n_layer_plans=eng_k.n_layer_plans,
                plan_fallbacks=eng_k.executor.plan_fallbacks,
                dropped_kernel_plain=drops)


def device_ms_by_name(prof, per: int = 1):
    """A profile's device ms by kernel name (each divided by ``per``) and
    launches by name, for the kernels that took device time."""
    by_name, counts = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3 / per
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return by_name, counts


def profile_steps(eng, prompts, n_steps: int = 4):
    """Where a steady decode step's time goes on a warm engine, three windows
    of ``n_steps`` steps each: the host's wall time with every profiler off;
    torch.profiler (device activity only) for device time and launches by
    kernel name; cProfile for the host functions the step spends its time in
    (its proportions, not its inflated total).  Busy over wall is the share of
    a step the device works; the rest it idles, waiting for the host to
    enqueue."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new=3 * n_steps + 4)
    eng.step()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    host = cProfile.Profile()
    host.enable()
    for _ in range(n_steps):
        eng.step()
    host.disable()
    while eng.active.any():
        eng.step()
    by_name, counts = device_ms_by_name(prof, n_steps)
    launched = sum(counts.values())
    busy = sum(by_name.values())
    if busy <= 0:
        fail("the profiler reported no device time for the decode steps")
    def is_port(name):
        return any(k in name for k in PORT_KERNELS)

    ours = sum(v for k, v in by_name.items() if is_port(k))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    port = {k.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ")[:48]: round(v, 4)
            for k, v in by_name.items() if is_port(k)}
    stats = pstats.Stats(host).stats  # (file, line, fn) -> (cc, nc, tt, ct, _)
    host_total = sum(v[2] for v in stats.values())
    host_top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    return dict(wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy,
                device_idle_share=max(0.0, 1.0 - busy / wall_ms),
                port_kernels_ms_per_step=ours,
                port_device_ms_per_step_by_kernel=port,
                device_kernels_per_step=launched / n_steps,
                kernels_by_count={
                    k.replace("(anonymous namespace)::", "")[:72]: v / n_steps
                    for k, v in sorted(counts.items(), key=lambda kv: -kv[1])[:16]},
                top_device_ms_per_step={k[:48]: round(v, 4) for k, v in top},
                host_share_by_function={
                    f"{Path(f).name}:{ln}:{fn}"[:60]: round(v[2] / host_total, 4)
                    for (f, ln, fn), v in host_top})


def site_weight(params, name):
    """Site ``name``'s dense-effective ``[K, N]`` weight in ``params``:
    ``attn.q.l0`` -> blocks.attn.q.w[0], ``moe.up.l1.e3`` -> blocks.ffn.up[1, 3],
    ``moe.shared.down.l2`` -> blocks.ffn.shared.down.w[2],
    ``shared_attn.ffn.up`` -> shared_attn.ffn.up.w,
    ``dec.xattn.q.l1`` -> dec_blocks.xattn.q.w[1]."""
    parts = name.split(".")
    if parts[0] in ("enc", "dec"):  # whisper: enc_blocks / dec_blocks
        return params[f"{parts[0]}_blocks"][parts[1]][parts[2]]["w"][
            int(parts[3][1:])]
    if parts[0] == "shared_attn":  # the hybrid's unstacked shared block
        return params["shared_attn"][parts[1]][parts[2]]["w"]
    if parts[:2] == ["moe", "shared"]:
        return params["blocks"]["ffn"]["shared"][parts[2]]["w"][int(parts[3][1:])]
    li = int(parts[2][1:])
    if parts[0] == "moe":
        return params["blocks"]["ffn"][parts[1]][li, int(parts[3][1:])]
    return params["blocks"][parts[0]][parts[1]]["w"][li]


def site_groups(cfg, li: int = 0):
    """Layer ``li``'s fused regions (and single sites) as the per-region
    route groups them."""
    if cfg.family == "ssm":  # rwkv6: time-mix r/k/v/g and o, channel-mix k/r and v
        return tuple(tuple(f"{q}.l{li}" for q in g) for g in (
            ("tm.r", "tm.k", "tm.v", "tm.g"), ("tm.o",), ("cm.k", "cm.r"),
            ("cm.v",)))
    if cfg.family == "hybrid":  # the mamba layers (the shared block: below)
        return ((f"mamba.in_proj.l{li}",), (f"mamba.out_proj.l{li}",))
    if cfg.family == "audio":  # whisper's decoder (xattn.k/v: static KV)
        return tuple(tuple(f"dec.{q}.l{li}" for q in g) for g in (
            ("attn.q", "attn.k", "attn.v"), ("attn.o",), ("xattn.q",),
            ("xattn.o",), ("mlp.fc1",), ("mlp.fc2",)))
    attn = ((("attn.q",), ("attn.dkv", "attn.kr"), ("attn.uk", "attn.uv"),
             ("attn.o",))
            if cfg.mla is not None else
            (("attn.q", "attn.k", "attn.v"), ("attn.o",)))
    if cfg.moe is None:
        groups = attn + (("ffn.gate", "ffn.up"), ("ffn.down",))
    else:
        groups = attn + (("moe.gate",), ("moe.up",), ("moe.down",))
        if cfg.moe.n_shared:
            groups += (("moe.shared.gate", "moe.shared.up"),
                       ("moe.shared.down",))
    ne = cfg.moe.n_experts if cfg.moe is not None else 0
    return tuple(tuple(f"{p}.l{li}.e{e}" for e in range(ne))
                 if p in ROUTED else tuple(f"{q}.l{li}" for q in g)
                 for g in groups for p in (g[0],))


def shared_groups(cfg):
    """The hybrid's weight-shared block's regions (no layer index: one set
    of sites, run once an insertion); none for the other families."""
    if cfg.family != "hybrid":
        return ()
    return (("shared_attn.attn.q", "shared_attn.attn.k", "shared_attn.attn.v"),
            ("shared_attn.attn.o",),
            ("shared_attn.ffn.gate", "shared_attn.ffn.up"),
            ("shared_attn.ffn.down",))


def shared_insertions(cfg) -> int:
    """Insertions of the hybrid's shared block in a decode step."""
    return cfg.n_layers // cfg.hybrid_period if cfg.family == "hybrid" else 0


def region_launches_per_step(cfg) -> int:
    """K1/K2 launches a decode step of the per-region route (the region
    preps come on top, :func:`region_preps_per_step`): one a region of
    :func:`site_groups` in every layer (an MoE projection's experts one
    launch of E) and one a region of the hybrid's shared block at every
    insertion."""
    return (len(site_groups(cfg)) * cfg.n_layers
            + len(shared_groups(cfg)) * shared_insertions(cfg))


def phase_full_serve(dev, cfg, art, fixture_s, ref_params=None, *,
                     max_len=MAX_LEN, setup=None, routed=None):
    """The per-region route at full width: every projection a K1 or K2
    launch (an MoE projection's experts one K2 launch of E), each fused
    region's or pruned site's input made by one K3 region-prep launch.
    ``ref_params``: float32 dense-effective weights for the per-site check
    where the records keep none on the host.  ``max_len`` and ``setup``
    go to :func:`serve`; ``routed(sites)`` is the set of sites the decode
    step runs (every site by default)."""
    predicted = (region_launches_per_step(cfg)
                 + region_preps_per_step(cfg, art.records))
    prompts = prompts_for(cfg, 6)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_count()  # counts of the main path start here ...
    t0 = time.perf_counter()
    eng, res, step_s = serve(art, dev, use_kernel=True, n_slots=BATCH,
                             prompts=prompts, max_new=16, max_len=max_len,
                             setup=setup)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated()
    telemetry = serve_telemetry(eng)
    for r in res:
        if r.error or not r.finished or len(r.tokens) != r.prompt_len + 16:
            fail(f"full serve: request did not finish cleanly: {r.error}")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            fail("full serve: token outside the vocabulary")
    ex = eng.executor
    want_routed = ex.sites if routed is None else routed(ex.sites)
    if ex.routed != want_routed:
        fail(f"full serve: routed sites off by "
             f"{sorted(ex.routed ^ want_routed)[:5]}")
    if eng.kernel_launches_per_step != predicted:
        fail(f"full serve: {eng.kernel_launches_per_step} launches per step, "
             f"the site table predicts {predicted}")
    if set(counts) != set(PER_REGION):
        fail(f"full serve: launched {sorted(counts)}, expected exactly the "
             f"per-region kernels {PER_REGION}")
    steps = eng.step_dispatches  # decode steps of the serve
    dropped = int(ex.moe_dropped) if ex.moe_dropped is not None else None
    # per-site float32 output of layer 0 against the dense-effective matrix
    rng = np.random.default_rng(3)
    site_err = {}
    with torch.no_grad():
        for names in site_groups(cfg) + shared_groups(cfg):
            k_in = site_weight(art.params, names[0]).shape[0]
            x = torch.from_numpy(rng.standard_normal((k_in, BATCH)).astype(np.float32)).to(dev)
            ys = (ex.grouped(names)([x] * len(names)) if len(names) > 1
                  else [ex.matvec(names[0])(x)])
            for nm, y in zip(names, ys):
                rec = art.records[nm]
                if rec.effective is not None:
                    kept = torch.from_numpy(rec.kept_columns).to(dev)
                    ref = torch.from_numpy(np.asarray(rec.effective, np.float32)
                                           ).to(dev) @ x[kept]
                else:
                    ref = site_weight(ref_params, nm).to(dev, torch.float32).T @ x
                site_err[nm] = float((y - ref).abs().max() / ref.abs().max())
    torch.cuda.synchronize()
    if max(site_err.values()) > 1e-3:
        fail(f"full serve: per-site output off the dense-effective: {site_err}")
    profile = profile_steps(eng, prompts)
    tokens = sum(len(r.tokens) - r.prompt_len for r in res)
    steady = step_s[1:] or step_s
    return dict(phase="full_serve", arch=cfg.name, layers=cfg.n_layers,
                d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab,
                dtype=cfg.compute_dtype,
                n_slots=BATCH, requests=len(prompts), max_new=16,
                fixture_s=fixture_s, tokens=tokens, wall_s=wall,
                # the route packs and uploads its groups at their first use
                # (as the reference builds them): inside the first step
                pack_s=None, upload_s=None,
                tokens_per_s=tokens / wall, steps=len(step_s),
                first_step_ms=step_s[0] * 1e3,
                ms_per_step=float(np.median(steady)) * 1e3,
                steady_tokens_per_s=len(prompts) / float(np.median(steady)),
                profile=profile, telemetry=telemetry,
                launches_per_step=eng.kernel_launches_per_step,
                decode_steps=steps,
                predicted_launches_per_step=predicted, launches=counts,
                routed=len(ex.routed), sites=len(ex.sites),
                routed_equals_sites=ex.routed == ex.sites,
                max_len=max_len,
                plan_fallbacks=eng.plan_stats()["fallbacks"],
                dropped_per_step=None if dropped is None else dropped / steps,
                site_rel_err_max=max(site_err.values()), site_rel_tol=1e-3,
                peak_device_bytes=peak,
                resident_device_bytes=torch.cuda.memory_allocated(),
                cached_tokens=sum(r.stats["cached_tokens"] for r in res),
                prefill_kinds=sorted({r.stats["prefill_kind"] for r in res}),
                # a tokenwise prefill runs one decode step a prompt token
                prefill_steps=sum(r.prompt_len for r in res
                                  if r.stats["prefill_kind"] == "tokenwise"),
                sample_tokens=res[0].tokens[res[0].prompt_len:]), counts, by_shape, eng


def two_step_logits(cfg, art, executor, dev, *, smax=MAX_LEN, setup=None):
    """Two decode steps' logits [2, B, V] float32 from a fresh cache
    (``setup(state)`` fills what the caller keeps in it: whisper's
    cross-KV)."""
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, BATCH, 1))).to(dev)
    st = api.init_decode_state(cfg, BATCH, smax, device=dev)
    if setup is not None:
        setup(st)
    out = []
    with torch.no_grad():
        for t in range(2):
            pos = torch.full((BATCH,), t, dtype=torch.long, device=dev)
            lg, st = api.decode(art.params, cfg, st, toks[t], pos,
                                executor=executor)
            out.append(lg.float())
    return torch.stack(out)


def phase_plan_serve(dev, cfg, art, stages, pack_s, l_reg=None, *,
                     predicted=None, expected=None, n_plans=1, fallbacks=None):
    """The plan route at full width, float32: the same 6 prompts x 16 new
    tokens on 8 slots, paged KV.  The whole-step plan (``stages``: its
    packed stages): a dense layer launches 4 stages (K6; gate+up with
    SwiGLU in its epilogue) and 3 step kernels (K7: 2 norms, attention); an
    MoE layer the same with its FFN stages eg (the dispatch as its gathered
    input, gated) and ed (the combine in its epilogue) and K8's route.  Other plan routes
    (deepseek's per-layer expert plans) pass their own ``predicted``
    launches a step, ``expected`` kernels, ``n_plans`` and ``fallbacks``.
    ``l_reg``: the per-region route's two-step logits on the same artifact
    (computed here when not given)."""
    moe = cfg.moe is not None
    if predicted is None:
        predicted = (8 if moe else 7) * cfg.n_layers
    if expected is None:
        expected = set(PLAN) | (set(MOE) if moe else set())
    fallbacks = fallbacks or {}
    prompts = prompts_for(cfg, 6)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what the card holds before the serve: the artifact's parameters and
    # the plan's uploaded stages (the per-region copies were freed)
    resident = torch.cuda.memory_allocated()
    param_bytes = sum(tensor_bytes(t) for t in leaves(art.params))
    stage_bytes = sum(tensor_bytes(*vars(device_stage(ps, dev)).values())
                      for ps in stages)
    dispatch.reset_launch_count()  # counts of the plan path start here ...
    t0 = time.perf_counter()
    eng, res, step_s = serve(art, dev, use_kernel=True, n_slots=BATCH,
                             prompts=prompts, max_new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated()
    telemetry = serve_telemetry(eng)
    for r in res:
        if r.error or not r.finished or len(r.tokens) != r.prompt_len + 16:
            fail(f"plan serve: request did not finish cleanly: {r.error}")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            fail("plan serve: token outside the vocabulary")
    ex = eng.executor
    if ex.routed != ex.sites:
        fail(f"plan serve: unrouted sites {sorted(ex.sites - ex.routed)[:5]}")
    if eng.n_layer_plans != n_plans or ex.plan_fallbacks != fallbacks:
        fail(f"plan serve: {eng.n_layer_plans} plans, fallbacks "
             f"{ex.plan_fallbacks}")
    if eng.kernel_launches_per_step != predicted:
        fail(f"plan serve: {eng.kernel_launches_per_step} launches per step, "
             f"the plan predicts {predicted}")
    if set(counts) != expected:
        fail(f"plan serve: launched {sorted(counts)}, expected exactly the "
             f"plan's kernels {sorted(expected)}")
    steps = eng.step_dispatches  # decode steps of the serve
    dropped = int(ex.moe_dropped) if ex.moe_dropped is not None else None
    # two decode steps' logits: plan route against the per-region route
    # (K1-K3) and the dense-effective weights, on the same float32 artifact
    l_plan = two_step_logits(cfg, art, ex, dev)
    if l_reg is None:
        l_reg = two_step_logits(
            cfg, art, CompressedExecutor(art, use_plans=False, device=dev), dev)
    torch.cuda.empty_cache()
    l_dense = two_step_logits(cfg, art, None, dev)
    scale = max(1.0, float(l_reg.abs().max()))
    route = dict(plan_vs_per_region=float((l_plan - l_reg).abs().max()) / scale,
                 plan_vs_dense=float((l_plan - l_dense).abs().max()) / scale)
    if not max(route.values()) <= ROUTE_TOL or not bool(torch.isfinite(l_plan).all()):
        fail(f"plan serve: logits off the other routes: {route}")
    profile = profile_steps(eng, prompts)
    tokens = sum(len(r.tokens) - r.prompt_len for r in res)
    steady = step_s[1:] or step_s
    return dict(phase="plan_serve", arch=cfg.name, dtype=cfg.compute_dtype,
                layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
                vocab=cfg.vocab, n_slots=BATCH, requests=len(prompts),
                max_new=16, pack_s=pack_s, tokens=tokens, wall_s=wall,
                tokens_per_s=tokens / wall, steps=len(step_s),
                first_step_ms=step_s[0] * 1e3,
                ms_per_step=float(np.median(steady)) * 1e3,
                steady_tokens_per_s=len(prompts) / float(np.median(steady)),
                profile=profile, telemetry=telemetry,
                launches_per_step=eng.kernel_launches_per_step,
                predicted_launches_per_step=predicted, decode_steps=steps,
                launches=counts, routed=len(ex.routed), sites=len(ex.sites),
                routed_equals_sites=ex.routed == ex.sites,
                n_layer_plans=eng.n_layer_plans, plan_fallbacks=ex.plan_fallbacks,
                dropped_per_step=None if dropped is None else dropped / steps,
                logits_rel_err=route, route_tol=ROUTE_TOL,
                peak_device_bytes=peak, resident_before_serve_bytes=resident,
                resident_device_bytes=torch.cuda.memory_allocated(),
                param_bytes=param_bytes, plan_stage_bytes=stage_bytes,
                cached_tokens=sum(r.stats["cached_tokens"] for r in res),
                sample_tokens=res[0].tokens[res[0].prompt_len:]), counts, by_shape


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def tensor_bytes(*objs) -> int:
    return sum(t.numel() * t.element_size() for t in objs
               if isinstance(t, torch.Tensor))


def drop_per_region_copies(art) -> None:
    """Free the per-region route's device copies (K1-K3 streams and FS
    blocks) that the kernel phase and the bf16 serve cached on the
    artifact's packed sites."""
    for pk in art.packed.values():
        pk._dev.clear()
    gc.collect()
    torch.cuda.empty_cache()


def upload_plan(arch, plan, dev, **extra) -> dict:
    """Validate, tabulate and upload a whole-step plan's stages; returns
    the phase line: host times and each stage's streams."""
    t0 = time.perf_counter()
    for ps in plan.stages.values():
        device_stage(ps, dev)  # validation, block tables, upload
    torch.cuda.synchronize()
    return dict(phase="fixture_and_plan", arch=arch, **extra,
                pack_s=plan.pack_s, upload_s=time.perf_counter() - t0,
                stages={name: dict(shape=list(ps.gidx.shape),
                                   outg=list(ps.outg.shape), k_alloc=ps.k_alloc,
                                   slices=device_stage(ps, dev).dims["E"],
                                   max_rows=device_stage(ps, dev).max_rows,
                                   live_terms=sum(device_stage(ps, dev).live_terms),
                                   stream_bytes=6 * ps.gidx.size,
                                   waste=ps.waste)
                        for name, ps in plan.stages.items()})


def fixture_line(base, art32, fixture_s) -> dict:
    """The phase line of a full-width seeded fixture cut in depth."""
    return dict(phase="fixture", arch=base.name, layers=base.n_layers,
                fixture_s=fixture_s, sites=len(art32.records),
                param_bytes=sum(tensor_bytes(t) for t in leaves(art32.params)),
                packed_host_bytes=sum(pk.idx.nbytes + pk.exp.nbytes + pk.sign.nbytes
                                      for pk in art32.packed.values()),
                host_peak_rss_bytes=host_peak_rss_bytes())


def seeded_cut(arch, layers, dev, **cut):
    """``(bf16 config, float32 config, float32 artifact, fixture seconds)``
    of ``arch`` at full width cut to ``layers`` layers (``cut``: other
    depths, whisper's ``enc_layers``); its phase line emitted."""
    base = replace(get_arch(arch), n_layers=layers, **cut)
    cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    art32 = seeded_artifact(cfg32, seed=2, device=dev, host_effective=False)
    torch.cuda.synchronize()
    fixture_s = time.perf_counter() - t0
    emit(fixture_line(base, art32, fixture_s))
    return base, cfg32, art32, fixture_s


def cast(tree, dtype):
    """The parameters in ``dtype``; the leaves the reference keeps in
    float32 (``convert.F32_LEAVES``: an MoE router, the recurrent mixes'
    small leaves) stay float32, as in ``convert.params_from_numpy``."""
    if isinstance(tree, dict):
        return {k: v if k in F32_LEAVES else cast(v, dtype)
                for k, v in tree.items()}
    return tree.to(dtype)


def kernel_rows(rows, serves):
    """The main-path rows of the kernels line: each row checked at a serve's
    own shapes, with the launches that serve made at exactly the row's
    dimensions (under ``counted_as``, the wrapper's count, where the row is
    an output mode of another kernel's launch).  ``serves`` maps a serve's
    name to its ``(counts, by_shape, decode steps)``; every launch of a
    serve must be at dimensions a row checked.  Rows of compositions
    (:data:`COMPOSITE`) have no launch of their own and stay out."""
    kernels = []
    for row in rows:
        if row.get("serve") is None or row["name"] in COMPOSITE:
            continue
        counts, by_shape, steps = serves[row["serve"]]
        n = by_shape.get((row.get("counted_as", row["name"]),
                          tuple(row["shape_key"])), 0)
        if n <= 0:
            fail(f"{row['name']} {row['shape']}: the {row['serve']} serve never "
                 f"launched at the checked dimensions {row['dims']}")
        kernels.append({**KERNELS[row["name"]], **row, "launches": n,
                        "launches_per_step": n / steps})
    for serve_name, (counts, by_shape, _) in serves.items():
        for name, total in counts.items():
            seen = sum(r["launches"] for r in kernels
                       if r.get("counted_as", r["name"]) == name
                       and r["serve"] == serve_name)
            if seen != total:
                shapes = sorted((k for (nm, k) in by_shape if nm == name), key=str)
                fail(f"{name}: {total} launches on the {serve_name} serve, "
                     f"{seen} of them at dimensions the kernel phase checked; "
                     f"launched at {shapes}")
    return kernels


def host_peak_rss_bytes() -> int:
    """The process's peak resident host memory (ru_maxrss is in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


# ------------------------------------------------- mixtral-8x22b (MoE, K8)


def kernel_case_moe(label, cfg, router, dev, timer, *, batch=BATCH, idle=0,
                    serve=None):
    """K8's route on one layer's router at ``batch`` columns, held to the
    plain version's experts, slots, source tokens and dropped count
    exactly, weights within SUM_TOL; the dispatch is stage eg's gathered
    input and the combine stage ed's combining epilogue
    (:func:`kernel_case_expert_stage`).  The last ``idle`` columns are
    equal, as idle slots are; they route alike and take capacity.  No
    single PyTorch call computes the route (top-k with capacity ranks), so
    there is no library time."""
    d, n_exp, k = cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k
    cap = capacity(batch, k, cfg.moe.capacity_factor, n_exp)
    kw = dict(top_k=k, cap=cap, norm_topk=cfg.moe.norm_topk)
    h2 = torch.randn((d, batch), device=dev)
    if idle:
        h2[:, batch - idle:] = h2[:, batch - idle: batch - idle + 1]
    i32 = dict(dtype=torch.int32, device=dev)
    dk, dp = torch.zeros(1, **i32), torch.zeros(1, **i32)
    got = moe_route(h2, router, dropped=dk, **kw)
    torch.cuda.synchronize()
    want = moe_route_plain(h2, router, dropped=dp, **kw)
    for part, a, b in zip(("experts", "slots", "source tokens"),
                          (got[0], got[2], got[3]), (want[0], want[2], want[3])):
        if not torch.equal(a, b):
            fail(f"{label} moe_route: {part} differ from the plain version")
    if int(dk) != int(dp):
        fail(f"{label} moe_route: {int(dk)} dropped, plain {int(dp)}")
    err = check_close(f"{label} moe_route weights", got[1], want[1], SUM_TOL)
    top = torch.sort(torch.softmax(h2.T @ router, -1), -1, descending=True).values
    margin = float((top[:, k - 1] - top[:, k]).min()) if k < n_exp else None
    dims = dict(d=d, B=batch, E=n_exp, k=k, cap=cap)
    return [kernel_row(
        "moe_route", label, dict(dims, dropped=int(dk), min_topk_margin=margin),
        (d, batch, n_exp, k, cap), err, True,
        lambda: moe_route(h2, router, **kw),
        lambda: moe_route_plain(h2, router, **kw), None,
        bound_of(4 * (d * batch + d * n_exp + 3 * batch * k + n_exp * cap),
                 2 * d * batch * n_exp), timer, serve=serve)]


def reduced_moe_cases(cfg, dev, timer):
    """K8 and the MoE step at reduced widths: capacity drops, idle columns,
    another expert count, top-k and a ragged batch, contiguous and paged
    caches, a window."""
    torch.manual_seed(80)
    rows = []
    for c, batch, idle in ((cfg, 8, 2), (replace(cfg, moe=replace(
            cfg.moe, n_experts=5, top_k=3)), 13, 0)):
        router = torch.randn((c.d_model, c.moe.n_experts), device=dev) \
            * c.d_model ** -0.5
        rows += kernel_case_moe(f"reduced E={c.moe.n_experts} k={c.moe.top_k}",
                                c, router, dev, timer, batch=batch, idle=idle)
    plan = CompressedExecutor(seeded_artifact(cfg, seed=3, device=dev),
                              device=dev).step_plan(cfg)
    rng = np.random.default_rng(81)
    rows.append(kernel_case_step("reduced mixtral paged", cfg, plan, rng, dev,
                                 timer))
    rows.append(kernel_case_step("reduced mixtral contiguous window=5", cfg,
                                 plan, rng, dev, timer, paged=False, window=5))
    return rows


def mixtral_region_cases(art, dev, timer, sm, serve):
    """The per-region kernels at the mixtral serve's own dimensions: layer
    0's attention sites (K1 on o, K2 on q+k+v at B = n_slots), each
    projection's experts as one K2 launch of E at B = capacity, and K3's
    region prep on every region (bf16, as the serve's)."""
    cfg = art.config
    ne = cfg.moe.n_experts
    cap = capacity(BATCH, cfg.moe.top_k, cfg.moe.capacity_factor, ne)
    rng = np.random.default_rng(60)
    pk = art.packed
    rows = [kernel_case_chain("mixtral attn.o", pk["attn.o.l0"], rng, dev,
                              timer, sm),
            kernel_case_group("mixtral attn.qkv",
                              [pk[f"attn.{p}.l0"] for p in "qkv"], rng, dev,
                              timer, sm)]
    for proj in ("gate", "up", "down"):
        rows.append(kernel_case_group(
            f"mixtral moe.{proj} G={ne}",
            [pk[f"moe.{proj}.l0.e{e}"] for e in range(ne)], rng, dev, timer,
            sm, batch=cap))
        gc.collect()
        torch.cuda.empty_cache()
    rows += region_cases(cfg, dev, timer, records=art.records)
    for row in rows:
        row["serve"] = serve
    return rows


def kernel_case_expert_stage(label, name, art, ps, dev, timer, *, batch,
                             serve, wl=0, mode=None):
    """K6 on layer 0 of an expert super-stage (``eg``: every expert's gate
    and up, e-major; ``ed``: every down) at B = capacity; for a one-layer
    stage of an MoE plan (K9), ``wl`` names the model layer it holds.  The
    library yardstick is one ``torch.bmm`` over the E experts' dense-effective
    float32 weights of layer ``wl``; the plain version (tens of GB of gathers
    at mixtral's width) is timed apart from it.  With ``mode``
    (:func:`mode_kwargs`) the row is the mode's, as in
    :func:`kernel_case_stage`: the stage in its plain modes (on the dense
    input, :func:`stage_input`) is held to the ``bmm`` and timed as
    ``stage_ms``, the ``bmm`` as ``dense_ms``."""
    cfg = art.config
    ne, dff, d = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    ds = device_stage(ps, dev)
    kw, key_mode = mode_kwargs(ps, batch, mode, dev)
    src, xin = stage_input(ps, kw, np.random.default_rng(71), batch, dev)
    y = stage_matmul(ps, xin, layer=0, **kw)
    torch.cuda.synchronize()
    plain = stage_matmul_plain(ps, xin, layer=0, **kw)
    err = check_close(label, y, plain, SUM_TOL)
    equal_to_plain = bool(torch.equal(y, plain))
    del plain
    torch.cuda.empty_cache()
    in_order = check_in_order(label, ps, xin, y, 0, **kw)
    torch.cuda.empty_cache()
    ms = timer(lambda: stage_matmul(ps, xin, layer=0, **kw))
    warm = timer(lambda: stage_matmul(ps, xin, layer=0, **kw), cold=False)
    plain_ms = timer(lambda: stage_matmul_plain(ps, xin, layer=0, **kw))
    torch.cuda.empty_cache()
    ffn = art.params["blocks"]["ffn"]
    if name == "eg":  # [E, 2 dff, d] @ [E, d, C]: gates then ups per expert
        w = torch.cat([ffn["gate"][wl], ffn["up"][wl]], dim=2).transpose(1, 2)
        x3 = src.reshape(ne, d, batch)

        def unpack(o):
            return torch.cat([o[:, :dff].reshape(ne * dff, batch),
                              o[:, dff:].reshape(ne * dff, batch)])
    else:  # [E, d, dff] @ [E, dff, C]
        w = ffn["down"][wl].transpose(1, 2)
        x3 = src.reshape(ne, dff, batch)

        def unpack(o):
            return o.reshape(ne * d, batch)
    y0 = stage_matmul(ps, src, layer=0) if kw else y
    check_close(label + " vs dense", y0, unpack(torch.bmm(w, x3)), 1e-4)
    del y0
    library_ms = timer(lambda: torch.bmm(w, x3))
    del w
    torch.cuda.empty_cache()
    extra = {}
    if kw:
        extra = dict(counted_as="stage_matmul", mode=key_mode[0],
                     equal_to_plain=equal_to_plain, dense_ms=library_ms,
                     stage_ms=timer(lambda: stage_matmul(ps, src, layer=0)))
        library_ms = None
    row_name = mode_row(key_mode)
    emit(dict(phase="kernel_case", name=row_name, shape=label, ms=ms,
              max_abs_err=err))
    bound = bound_of(*mode_cost(ds, 0, batch, kw))
    return dict(name=row_name, shape=label,
                dims=stage_dims(ds, batch),
                shape_key=list(ds.shape_key(batch, 1, key_mode)),
                max_abs_err=err, max_err=err, exact_in_kernel_order=in_order,
                ms=ms, kernel_ms=ms, live_terms=ds.live_terms[0],
                run_terms=ds.maps[0].run_terms if ds.maps else 0,
                segs=ps.segs is not None,
                warm_l2_ms=warm, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=library_ms, serve=serve, **extra)


def mixtral_plan_cases(art, plan, dev, timer, serve):
    """K6, K7 and K8 at the mixtral plan serve's own dimensions: layer 0 of
    the attention stages (B = n_slots) and of the expert super-stages (B =
    capacity; eg gathered and gated, ed combining, for n_slots tokens), the
    route on layer 0's router (two idle columns, as the serve has), and
    one full-width step."""
    cfg = art.config
    cap = capacity(BATCH, cfg.moe.top_k, cfg.moe.capacity_factor,
                   cfg.moe.n_experts)
    rng = np.random.default_rng(70)
    rows = []
    for name in ("qkv", "o"):
        rows.append(kernel_case_stage(f"mixtral {name}", plan.stages[name],
                                      rng, dev, timer,
                                      w=stage_weights(art, name, 0, dev)))
        torch.cuda.empty_cache()
    for name in ("eg", "ed"):
        rows.append(kernel_case_expert_stage(f"mixtral {name}", name, art,
                                             plan.stages[name], dev, timer,
                                             batch=cap, serve=serve,
                                             mode=serve_mode(cfg, name)))
        gc.collect()
        torch.cuda.empty_cache()
    torch.manual_seed(72)
    rows += kernel_case_moe("mixtral", cfg, plan.moe["router"][0], dev, timer,
                            idle=2)
    rows.append(kernel_case_step("mixtral full step", cfg, plan, rng, dev,
                                 timer, window=cfg.attn_window))
    rows.append(kernel_case_norm(cfg, dev, timer))
    rows.append(kernel_case_attention("mixtral attention", cfg, MAX_LEN,
                                      cfg.attn_window, serve_positions(rng),
                                      dev, timer))
    torch.cuda.empty_cache()
    for row in rows:
        row["serve"] = serve
    return rows


def run_mixtral(dev):
    """mixtral-8x22b at full width, cut to MIXTRAL_LAYERS layers: K8 and the reduced
    serve, the fixture, the per-region kernels and serve (bf16), the plan
    (packed and uploaded), its kernels and the float32 plan serve.  Returns
    the kernel rows and the serves' launch counts."""
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    red = reduced_config(get_arch("mixtral-8x22b"), vocab=256)
    # capacity 4 for 8 slots x 2 choices over 4 experts: drops occur
    red = replace(red, moe=replace(red.moe, capacity_factor=0.5))
    rows = reduced_moe_cases(red, dev, timer)
    emit(dict(phase="kernels", arch="mixtral-8x22b reduced",
              rows=[r for r in rows]))
    emit(phase_reduced_serve(dev, red, n_slots=8, n_prompts=8))
    torch.cuda.empty_cache()

    base, cfg32, art32, fixture_s = seeded_cut("mixtral-8x22b", MIXTRAL_LAYERS,
                                               dev)

    # per-region route: bf16, a cast of the same parameters
    region = f"{base.name} per-region"
    art16 = replace(art32, config=base, params=cast(art32.params, torch.bfloat16),
                    plans={})
    rows += mixtral_region_cases(art16, dev, timer, sm, region)
    full, counts, by_shape, eng = phase_full_serve(dev, base, art16, fixture_s,
                                                   ref_params=art32.params)
    full["host_peak_rss_bytes"] = host_peak_rss_bytes()
    emit(full)
    # the float32 per-region logits on the same artifact, through the groups
    # the serve uploaded
    ex32 = CompressedExecutor(art32, use_plans=False, device=dev)
    ex32._groups = eng.executor._groups
    l_reg = two_step_logits(cfg32, art32, ex32, dev)
    serves = {region: (counts, by_shape, full["decode_steps"])}
    del eng, ex32, art16
    drop_per_region_copies(art32)

    # plan route: float32
    plan = CompressedExecutor(art32, device=dev).step_plan(cfg32)
    emit(upload_plan(base.name, plan, dev,
                     host_peak_rss_bytes=host_peak_rss_bytes()))
    psv = f"{base.name} plan"
    rows += mixtral_plan_cases(art32, plan, dev, timer, psv)
    planned, pcounts, pshape = phase_plan_serve(
        dev, cfg32, art32, plan.stages.values(), plan.pack_s, l_reg=l_reg)
    planned["host_peak_rss_bytes"] = host_peak_rss_bytes()
    emit(planned)
    serves[psv] = (pcounts, pshape, planned["decode_steps"])
    return rows, serves


# ------------------------------------------- the prefix cache (tail extend)

PREFIX_HEAD = 96  # the shared head: 6 blocks of 16 tokens
PREFIX_TAIL = 8  # each request's own tail
PREFIX_REQUESTS = 4


def prefix_prompts(cfg, head=PREFIX_HEAD, tail=PREFIX_TAIL, n=PREFIX_REQUESTS):
    """``n`` prompts of one ``head``-token head and a ``tail``-token tail
    each (Markov text, seeded)."""
    lm = MarkovLM(vocab=cfg.vocab, k=8, seed=0)
    h = lm.sample(1, head, seed=200)[0, :head].tolist()
    return [h + lm.sample(1, tail, seed=300 + i)[0, :tail].tolist()
            for i in range(n)]


class StepLogits:
    """Keeps every decode step's logits ([B, V] float32, on the device)
    while it is entered: ``api.decode``, which the engine's step calls,
    wrapped for the span."""

    def __init__(self):
        self.steps = []

    def __enter__(self):
        self._real = api.decode

        def spy(*a, **k):
            out = self._real(*a, **k)
            self.steps.append(out[0].float().clone())
            return out

        api.decode = spy
        return self

    def __exit__(self, *exc):
        api.decode = self._real


def prefix_serve(art, dev, prompts, *, prefix_cache, n_slots=BATCH,
                 max_new=16):
    """The prompts submitted one after another to a paged engine (the
    prefill of each synced and timed), then decoded to the end through
    ``step()`` with every step's logits kept.  The requests land in slots
    0.. in order, so decode step j samples every request's j-th token."""
    eng = ServingEngine(artifact=art, n_slots=n_slots, max_len=MAX_LEN,
                        kv_block=16, prefix_cache=prefix_cache, device=dev)
    dispatch.reset_launch_count()  # counts of the serve start here ...
    prefill_ms, rids = [], []
    for p in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids.append(eng.submit(p, max_new=max_new))
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    step_s = []
    with StepLogits() as lg:
        while eng.active.any():
            t0 = time.perf_counter()
            eng.step()
            step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    res = [eng.results[r] for r in rids]
    for r in res:
        if r.error or not r.finished or len(r.tokens) != r.prompt_len + max_new:
            fail(f"prefix serve: a request did not finish cleanly: {r.error}")
    stats = eng.pool_stats()
    if stats["in_use_blocks"] != 0:
        fail(f"prefix serve: {stats['in_use_blocks']} blocks still in use")
    profiled = profile_prefill(eng, prompts[1])
    return dict(eng=eng, res=res, prefill_ms=prefill_ms, step_s=step_s,
                logits=torch.stack(lg.steps), counts=counts, by_shape=by_shape,
                pool=stats, profiled=profiled)


def profile_prefill(eng, prompt):
    """One more admission of ``prompt`` on a served engine (a prefix hit
    where the cache is on), its prefill under ``torch.profiler``: the synced
    wall ms and the device's busy ms (kernels by time); the request is then
    cancelled, returning its blocks."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rid = eng.submit(prompt, max_new=1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    eng.cancel(rid)
    if eng.pool_stats()["in_use_blocks"] != 0:
        fail("prefix serve: the profiled request left blocks in use")
    by_name, _ = device_ms_by_name(prof)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return dict(cached_tokens=eng.results[rid].stats["cached_tokens"],
                wall_ms=wall, device_busy_ms=busy,
                device_idle_share=max(0.0, 1.0 - busy / wall),
                top_device_ms={k[:48]: round(v, 4) for k, v in top})


def prefix_route(label, art, dev, prompts, *, exact):
    """One route's cold serve (prefix cache off) and warm serve (on) of the
    same prompts: prefill ms, hit tokens, COW copies, blocks in use, launches
    a decode step (the warm serve's must equal the cold one's), the first
    decode step's logits against each other; ``exact``: the greedy tokens
    must be identical, else a differing token is reported with the cold
    serve's top-2 margin at that step.  Returns the route's line and the two
    serves' launch counts, summed."""
    cold = prefix_serve(art, dev, prompts, prefix_cache=False)
    warm = prefix_serve(art, dev, prompts, prefix_cache=True)
    head = len(prompts[0]) - PREFIX_TAIL
    cached = [r.stats["cached_tokens"] for r in warm["res"]]
    if cached != [0] + [head] * (len(prompts) - 1) or any(
            r.stats["cached_tokens"] for r in cold["res"]):
        fail(f"prefix {label}: cached tokens {cached}, expected the head "
             f"({head}) on every request after the first")
    lps = [e["eng"].kernel_launches_per_step for e in (cold, warm)]
    if lps[0] != lps[1] or set(cold["counts"]) != set(warm["counts"]):
        fail(f"prefix {label}: launches a step cold/warm {lps}, kernels "
             f"{sorted(cold['counts'])} / {sorted(warm['counts'])}")
    n = len(prompts)
    first = (warm["logits"][0, :n] - cold["logits"][0, :n]).abs().max()
    differ = []
    for i, (rc, rw) in enumerate(zip(cold["res"], warm["res"])):
        tc, tw = rc.tokens[rc.prompt_len:], rw.tokens[rw.prompt_len:]
        if tc != tw:
            j = next(k for k in range(len(tc)) if tc[k] != tw[k])
            top2 = torch.topk(cold["logits"][j, i], 2).values
            differ.append(dict(request=i, step=j, cold_top2_margin=float(
                top2[0] - top2[1])))
    if exact and differ:
        fail(f"prefix {label}: warm tokens differ from the cold serve's: {differ}")
    summed = {k: cold["counts"].get(k, 0) + warm["counts"].get(k, 0)
              for k in set(cold["counts"]) | set(warm["counts"])}
    by_shape = {k: cold["by_shape"].get(k, 0) + warm["by_shape"].get(k, 0)
                for k in set(cold["by_shape"]) | set(warm["by_shape"])}
    steps = sum(e["eng"].step_dispatches for e in (cold, warm))
    line = dict(route=label, dtype=art.config.compute_dtype,
                prompts=[len(p) for p in prompts], head=head,
                cold_prefill_ms=cold["prefill_ms"],
                warm_prefill_ms=warm["prefill_ms"],
                warm_hit_prefill_ms_mean=float(np.mean(warm["prefill_ms"][1:])),
                cold_prefill_ms_mean=float(np.mean(cold["prefill_ms"][1:])),
                cached_tokens=cached,
                prefix_hit_tokens=warm["pool"]["prefix_hit_tokens"],
                prefix_hit_rate=warm["pool"]["prefix_hit_rate"],
                cow_copies=warm["pool"]["cow_copies"],
                blocks_in_use_after=warm["pool"]["in_use_blocks"],
                cached_blocks_after=warm["pool"]["cached_blocks"],
                launches_per_step_cold_warm=lps,
                ms_per_step_cold_warm=[float(np.median(e["step_s"][1:])) * 1e3
                                       for e in (cold, warm)],
                first_step_logits_max_abs_diff=float(first),
                profiled_prefill_cold_warm=[cold["profiled"], warm["profiled"]],
                tokens_identical=not differ, differing_tokens=differ)
    return line, (summed, by_shape, steps)


def prefix_reduced(dev):
    """The reduced configs on the card: deepseek-v2-lite (MLA, the K9
    route) warm == cold tokens through ``mla_extend``; olmo-1b's tokenwise
    prefill (contiguous, one decode step a prompt token through the plan
    route) == its bulk prefill."""
    cfg = reduced_config(get_arch("deepseek-v2-lite-16b"), vocab=256)
    art = seeded_artifact(cfg, seed=1, device=dev)
    prompts = prefix_prompts(cfg, head=32, tail=5)
    cold = prefix_serve(art, dev, prompts, prefix_cache=False, n_slots=4,
                        max_new=8)
    warm = prefix_serve(art, dev, prompts, prefix_cache=True, n_slots=4,
                        max_new=8)
    cached = [r.stats["cached_tokens"] for r in warm["res"]]
    if ([r.tokens for r in warm["res"]] != [r.tokens for r in cold["res"]]
            or cached != [0, 32, 32, 32]):
        fail(f"prefix deepseek reduced: warm tokens differ from cold, or "
             f"cached {cached}")
    ocfg = reduced_config(get_arch("olmo-1b"), vocab=256)
    oart = seeded_artifact(ocfg, seed=1, device=dev)
    oprompts = [p[:9 + 2 * i] for i, p in enumerate(prefix_prompts(ocfg, 16, 1, 3))]
    out = {}
    for kind, bulk in (("bulk", True), ("tokenwise", False)):
        eng = ServingEngine(artifact=oart, n_slots=2, max_len=64, kv_block=None,
                            bulk_prefill=bulk, device=dev)
        res = eng.generate(oprompts, max_new_tokens=8)
        if {r.stats["prefill_kind"] for r in res} != {kind}:
            fail(f"prefix olmo reduced: prefill kinds {res[0].stats}")
        out[kind] = [r.tokens for r in res]
    if out["bulk"] != out["tokenwise"]:
        fail("prefix olmo reduced: tokenwise prefill tokens differ from bulk")
    return dict(deepseek_reduced=dict(cached_tokens=cached,
                                      tokens_warm_equal_cold=True,
                                      prefill_ms_cold=cold["prefill_ms"],
                                      prefill_ms_warm=warm["prefill_ms"]),
                olmo_reduced_tokenwise_equals_bulk=True,
                olmo_reduced_prompts=[len(p) for p in oprompts])


def phase_prefix(dev, base, art32):
    """The prefix cache at full width (``--only prefix``; in the full run
    after olmo-1b's plan serve, on its fixture): four prompts of one
    96-token head and their own 8-token tails, 16 new tokens each on 8
    slots, ``max_len`` 128, served with the prefix cache off (cold) and on
    (warm) — the float32 plan route on ``art32`` (its plan already
    uploaded), then the bf16 per-region route on a cast of its params.  The
    warm serve prefills the first request whole and each later one's tail
    only (``prefill_extend`` against the gathered head).  Then the reduced
    deepseek-v2-lite (MLA) warm == cold and olmo-1b's tokenwise == bulk.
    Returns the line and, by route, the serves' summed launch counts."""
    prompts = prefix_prompts(base)
    t0 = time.perf_counter()
    plan_line, plan_counts = prefix_route("plan", art32, dev, prompts,
                                          exact=True)
    art16 = replace(art32, config=base, params=cast(art32.params, torch.bfloat16),
                    plans={})
    region_line, region_counts = prefix_route("per-region", art16, dev, prompts,
                                              exact=False)
    del art16
    drop_per_region_copies(art32)
    gc.collect()
    torch.cuda.empty_cache()
    line = dict(phase="prefix", arch=base.name, n_slots=BATCH, max_len=MAX_LEN,
                kv_block=16, max_new=16, routes=[plan_line, region_line],
                **prefix_reduced(dev), seconds=time.perf_counter() - t0)
    return line, {"plan": plan_counts, "per-region": region_counts}


# ------------------------------------------------- telemetry (obs/)

OVERHEAD_ROUNDS = 150  # single steps of each engine an attempt
OVERHEAD_ATTEMPTS = 3  # up to three, as the reference's test
OVERHEAD_BOUND = 0.03  # the reference's bound (tests/test_obs.py)
OVERHEAD_MAX_LEN = 512  # room for 2 + 3 x 150 steps after an 8-token prompt


def phase_overhead(dev, cfg, art):
    """Telemetry's cost on olmo-1b's float32 plan route (its uploaded
    artifact): an engine with full telemetry (registry, profiler, tracer,
    the scheduler's spans and gauges) against one with ``metrics=False``,
    8 slots each held busy, alternated one step at a time, the order
    rotated each round, compared on per-step medians; as in the reference's
    test, attempts stop at the first within its 3 % and the best of (up to)
    three must be, with identical tokens.  Also one profiler fence on a
    CUDA tensor."""
    prompts = prompts_for(cfg, BATCH)

    def prime(**kw):
        eng = ServingEngine(artifact=art, n_slots=BATCH,
                            max_len=OVERHEAD_MAX_LEN, kv_block=16,
                            device=dev, **kw)
        sched = Scheduler(eng)
        for p in prompts:
            sched.enqueue(p, max_new=eng.max_len)
        for _ in range(2):  # admit + warm
            sched.step()
        return eng, sched

    engines = {"on": prime(tracer=True), "off": prime(metrics=False)}

    def measure() -> dict:
        walls = {k: [] for k in engines}
        order = list(engines)
        for i in range(OVERHEAD_ROUNDS):
            for k in order[i % 2:] + order[:i % 2]:
                sched = engines[k][1]
                t0 = time.perf_counter()
                sched.step()  # ends in the step's device->host copy
                walls[k].append(time.perf_counter() - t0)
        med = {k: float(np.median(w)) for k, w in walls.items()}
        return dict(median_ms_on=med["on"] * 1e3, median_ms_off=med["off"] * 1e3,
                    overhead=med["on"] / med["off"] - 1.0)

    t0 = time.perf_counter()
    attempts = []
    for _ in range(OVERHEAD_ATTEMPTS):
        attempts.append(measure())
        if attempts[-1]["overhead"] <= OVERHEAD_BOUND:
            break
    seconds = time.perf_counter() - t0
    (on, son), (off, soff) = engines["on"], engines["off"]
    if not (on.active.all() and off.active.all()):
        fail("telemetry overhead: a batch drained before the last timed step")
    tokens_on = [r.tokens for _, r in sorted(son.results.items())]
    tokens_off = [r.tokens for _, r in sorted(soff.results.items())]
    if tokens_on != tokens_off:
        fail("telemetry overhead: the engines with and without telemetry "
             "sampled other tokens")
    steps = 2 + len(attempts) * OVERHEAD_ROUNDS
    if (on.profiler.total_steps != steps
            or metric(on, "serving_decode_steps_total") != steps
            or on.tracer.open_count != BATCH):
        fail(f"telemetry overhead: {on.profiler.total_steps} profiled steps, "
             f"{on.tracer.open_count} open spans; expected {steps}, {BATCH}")
    best = min(a["overhead"] for a in attempts)
    if best > OVERHEAD_BOUND:
        fail(f"telemetry overhead {best:.2%} exceeds the "
             f"{OVERHEAD_BOUND:.0%} bound: {attempts}")
    # the profiler's fence on the card: one synchronize, counted
    prof = StepProfiler(fence_every=1)
    prof.end(prof.begin(), fence={"x": torch.ones(4, device=dev)})
    if prof.summary()["fenced"] != 1:
        fail("telemetry overhead: the profiler's CUDA fence was not counted")
    line = dict(phase="telemetry_overhead", arch=cfg.name,
                dtype=cfg.compute_dtype, route="plan", n_slots=BATCH,
                max_len=OVERHEAD_MAX_LEN, rounds=OVERHEAD_ROUNDS,
                attempts=attempts, overhead_best=best,
                overhead_bound=OVERHEAD_BOUND,
                telemetry_host_us_per_step=(
                    min(a["median_ms_on"] - a["median_ms_off"]
                        for a in attempts) * 1e3),
                launches_per_step=on.kernel_launches_per_step,
                tokens_identical=True, cuda_fence_counted=True,
                profiler=on.profiler.summary(),
                trace_open_spans=on.tracer.open_count, seconds=seconds)
    del engines, on, off, son, soff
    gc.collect()
    torch.cuda.empty_cache()
    return line


def phase_serve_launcher(dev):
    """The serve launcher, in process, on the card (``--reduced --kernel``,
    the reduced float32 plan route): its ``--metrics-out`` file holds the
    engine's registry and the process-wide launch counter, its
    ``--trace-out`` file one span a request, each ``ok``."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import serve as serve_launcher

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        mpath, tpath = os.path.join(d, "metrics.json"), os.path.join(d, "trace.jsonl")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            serve_launcher.main(["--reduced", "--kernel", "--metrics-out",
                                 mpath, "--trace-out", tpath])
        seconds = time.perf_counter() - t0
        payload = json.loads(Path(mpath).read_text())
        spans = [json.loads(line) for line in
                 Path(tpath).read_text().splitlines()]
    metrics = payload["metrics"]

    def value(name, **labels):
        rows = [r for r in metrics.get(name, {}).get("values", [])
                if r["labels"] == labels]
        return rows[0]["value"] if rows else None

    requests, max_new = 6, 16  # the launcher's defaults
    got = dict(kernel_launches_total=value("kernel_launches_total"),
               launches_per_step=value("serving_kernel_launches_per_step",
                                       bucket="4x1"),
               tokens=value("serving_tokens_total"),
               requests_ok=value("serving_requests_total", status="ok"),
               layer_plans=value("serving_layer_plans"),
               spans=len(spans),
               statuses=sorted({s["status"] for s in spans}))
    if (not got["kernel_launches_total"] or got["launches_per_step"] != 14
            or got["tokens"] != requests * max_new
            or got["requests_ok"] != requests or got["layer_plans"] != 1
            or got["spans"] != requests or got["statuses"] != ["ok"]
            or set(payload) != {"metrics", "trace_summary", "profiler",
                                "live_roofline"}):
        fail(f"serve launcher: telemetry files hold {got}")
    return dict(phase="serve_launcher", argv="--reduced --kernel "
                "--metrics-out F --trace-out G", seconds=seconds,
                metrics=len(metrics), **got,
                trace_summary=payload["trace_summary"],
                profiler=payload["profiler"],
                summary_lines=[line for line in out.getvalue().splitlines()
                               if line.startswith("  ")][:8])


def merge_serve(a, b):
    """Two serves' ``(counts, by_shape, decode steps)`` summed."""
    return ({k: a[0].get(k, 0) + b[0].get(k, 0) for k in set(a[0]) | set(b[0])},
            {k: a[1].get(k, 0) + b[1].get(k, 0) for k in set(a[1]) | set(b[1])},
            a[2] + b[2])


def run_olmo(dev, layers):
    """olmo-1b at full width: the kernel phase, the reduced serve, the bf16
    per-region serve (cut to OLMO_CUT_LAYERS), the float32 plan serve, the
    prefix cache's cold and warm serves on both routes (cut to
    OLMO_CUT_LAYERS), the serving mesh's check (cut to MESH_SERVE_LAYERS)
    and the artifact on disk.  Returns the kernel rows and the serves'
    launch counts (a route's prefix serves counted with its serve: they
    launch at its dimensions)."""
    base = get_arch("olmo-1b")
    if layers is not None:
        base = replace(base, n_layers=layers)
    # the plan needs a float32 compute dtype; the per-region serve keeps
    # olmo-1b's own bf16 and takes a cast of the same parameters
    cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
    red_cfg = reduced_config(get_arch("olmo-1b"), vocab=256)

    # the full-width artifact and its plan come first: the kernel phase takes
    # its main-path cases from them
    t0 = time.perf_counter()
    art32 = seeded_artifact(cfg32, seed=2, device=dev)
    torch.cuda.synchronize()
    fixture_s = time.perf_counter() - t0
    # the per-region serve and the prefix cache's serves: the fixture's
    # first OLMO_CUT_LAYERS layers (the per-region one a bf16 cast of them)
    n_cut = min(OLMO_CUT_LAYERS, base.n_layers)
    cut32 = first_layers(art32, n_cut)
    cut16 = replace(cut32, config=replace(base, n_layers=n_cut),
                    params=cast(cut32.params, torch.bfloat16))
    plan = CompressedExecutor(art32, device=dev).step_plan(cfg32)
    emit(upload_plan(base.name, plan, dev, fixture_s=fixture_s))

    rows = phase_kernels(dev, art32, plan, red_cfg)
    frows, factor_serve = phase_factor_route(dev, art32, Timer(dev))
    rows += frows
    emit(dict(phase="kernels", arch=base.name, tolerance=SUM_TOL,
              tolerance_reason="float32 sums in another order than the "
                               "plain version's (over E slices, J gathers, "
                               "S terms); where every sum is exact the "
                               "results are bit-identical",
              step_tolerance=STEP_TOL, rows=rows))
    emit(phase_reduced_serve(dev, red_cfg))
    emit(phase_serve_launcher(dev))
    full, full_counts, by_shape, eng = phase_full_serve(dev, cut16.config,
                                                        cut16, fixture_s)
    emit(full)
    # the plan serve's peak counts the plan route's own bytes: the bf16 cast
    # and the per-region streams go first
    del eng, cut16
    drop_per_region_copies(art32)
    planned, plan_counts, plan_shape = phase_plan_serve(
        dev, cfg32, art32, plan.stages.values(), plan.pack_s)
    emit(planned)
    emit(phase_overhead(dev, cfg32, art32))
    CompressedExecutor(cut32, device=dev).step_plan(cut32.config)
    pline, pserves = phase_prefix(dev, replace(base, n_layers=n_cut), cut32)
    emit(pline)
    del cut32
    emit(phase_mesh_serve(dev, first_layers(
        art32, min(MESH_SERVE_LAYERS, base.n_layers))))
    del art32, plan
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase_artifact(dev, base))
    return rows, {f"{base.name} per-region": merge_serve(
                      (full_counts, by_shape, full["decode_steps"]),
                      pserves["per-region"]),
                  f"{base.name} plan": merge_serve(
                      (plan_counts, plan_shape, planned["decode_steps"]),
                      pserves["plan"]),
                  FACTOR_ROUTE: factor_serve}


# ------------------------------------------------- the artifact on disk


def rss_now() -> dict:
    """Resident host memory now, in bytes: all of it and, where the kernel
    reports them, anonymous and file backed (a mapped shard's pages count
    as file)."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key = line.split(":")[0]
            if key in ("VmRSS", "RssAnon", "RssFile"):
                out[key] = int(line.split()[1]) * 1024
    return out


def reckon_artifact(art) -> tuple[dict, tuple[str, int]]:
    """The bytes ``CompressedModel.save`` writes, by top-level group
    (params, units, packed, plans; records' effective maps and centroids
    as float64, as the format stores them), and the largest leaf."""
    groups = dict.fromkeys(("params", "units", "packed", "plans"), 0)
    leaves: dict[str, int] = {}

    def add(group, name, nbytes):
        groups[group] += nbytes
        leaves[f"{group}/{name}"] = nbytes

    stack = [("", art.params)]
    while stack:
        name, t = stack.pop()
        if isinstance(t, dict):
            stack += [(f"{name}/{k}", v) for k, v in t.items()]
        else:
            add("params", name, tensor_bytes(t))
    for name, rec in art.records.items():
        add("units", f"{name}/kept", 8 * rec.kept_columns.size)
        add("units", f"{name}/effective", 8 * rec.effective.size)
        if rec.shared is not None:
            add("units", f"{name}/labels", rec.shared.labels.nbytes)
            add("units", f"{name}/centroids", 8 * rec.shared.centroids.size)
        for i, sl in enumerate(rec.decomposition.slices):
            for j, f in enumerate(getattr(sl, "factors", ())):
                for a in ("idx", "exp", "sign"):
                    add("units", f"{name}/dec/s{i:03d}/f{j:02d}/{a}",
                        getattr(f, a).nbytes)
    for name, pk in art.packed.items():
        for a in ("idx", "exp", "sign"):
            add("packed", f"{name}/{a}", getattr(pk, a).nbytes)
        for i, (_, w) in enumerate(pk.dense):
            add("packed", f"{name}/dense/d{i:02d}", np.asarray(w).nbytes)
    for key, stages in art.plans.items():
        for sname, ps in stages.items():
            for f in ("prep_src", "prep_tgt", "gidx", "gexp", "gsgn", "outg",
                      "fs_mat", "dw_mat", "bias", "segs"):
                if getattr(ps, f) is not None:
                    add("plans", f"{key}/{sname}/{f}", getattr(ps, f).nbytes)
    return groups, max(leaves.items(), key=lambda kv: kv[1])


def route_result(eng, res, step_s, counts, art, dev) -> dict:
    """What the artifact phase keeps of a serve on ``art``: every request's
    tokens, two decode steps' logits through the serve's executor, launches
    a step and by kernel, ms a step and, on the plan route, ``pack_s``."""
    logits = two_step_logits(art.config, art, eng.executor, dev)
    plan = eng.executor.step_plan(art.config) if eng.n_layer_plans else None
    return dict(tokens=[r.tokens for r in res], logits=logits.cpu(),
                launches_per_step=eng.kernel_launches_per_step,
                launches=counts,
                ms_per_step=float(np.median(step_s[1:] or step_s)) * 1e3,
                pack_s=None if plan is None else plan.pack_s)


def route_results(art, base, dev) -> dict:
    """``art`` (float32, its step plan in ``plans``) served on both routes,
    6 prompts x 16 tokens on 8 slots: the float32 plan (K6/K7) and, on a
    bf16 cast of its parameters, the per-region route (K1/K2/K3).  For
    each: every request's tokens, two decode steps' logits, launches a step
    and the kernels launched."""
    out = {}
    prompts = prompts_for(base, 6)
    art16 = replace(art, config=base, params=cast(art.params, torch.bfloat16),
                    plans={})
    for route, a in (("plan", art), ("per-region", art16)):
        dispatch.reset_launch_count()  # counts of the serve start here ...
        eng, res, step_s = serve(a, dev, use_kernel=True, n_slots=BATCH,
                                 prompts=prompts, max_new=16)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()  # ... and are read here
        for r in res:
            if r.error or not r.finished or len(r.tokens) != r.prompt_len + 16:
                fail(f"artifact {route}: a request did not finish: {r.error}")
        out[route] = route_result(eng, res, step_s, counts, a, dev)
        del eng
    del art16
    drop_per_region_copies(art)
    return out


def phase_artifact(dev, base):
    """The artifact on disk at full width (``--only artifact``; in the full
    run right after olmo-1b's prefix-cache serves), on a seeded float32
    fixture of ``base`` cut to ARTIFACT_LAYERS layers with its step plan
    packed into ``plans``: the bytes reckoned by group and the temp
    directory's free space checked (a lack of room fails); the in-memory
    artifact served on both routes and only those results kept; saved
    (``save_s``), dropped, loaded through the map (``load_s``, host RSS
    after the load and after the plan's upload, ``pack_s`` of the plan read
    from disk) and served again: tokens, two steps' logits and launches bit
    for bit the in-memory serves'; then the same shard decoded from one
    whole-file read through the same decoder, the reference's way, for its
    time and RSS.  The directory is removed at the end."""
    import shutil
    import tempfile

    from repro_torch.core.artifact import CompressedModel

    t_phase = time.perf_counter()
    base = replace(base, n_layers=min(ARTIFACT_LAYERS, base.n_layers))
    cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
    art = seeded_artifact(cfg32, seed=2, device=dev)
    CompressedExecutor(art, device=dev).step_plan(cfg32)  # into art.plans
    groups, leaf = reckon_artifact(art)
    total = sum(groups.values())
    tmp_root = tempfile.gettempdir()
    disk = shutil.disk_usage(tmp_root)
    emit(dict(phase="artifact_reckoning", arch=base.name, layers=cfg32.n_layers,
              d_model=cfg32.d_model, d_ff=cfg32.d_ff, bytes_by_group=groups,
              bytes_total=total, largest_leaf=leaf[0], largest_leaf_bytes=leaf[1],
              bin32_limit=msgpack_codec.BIN_LIMIT, tmp_dir=tmp_root,
              disk_free_bytes=disk.free, disk_total_bytes=disk.total))
    if leaf[1] > msgpack_codec.BIN_LIMIT:
        fail(f"artifact: leaf {leaf[0]} is {leaf[1]} bytes, above msgpack's "
             "bin32 limit: cut the depth")
    if total > 0.95 * disk.free:
        fail(f"artifact: {total} bytes do not fit the {disk.free} free bytes "
             f"of {tmp_root}: cut the depth")
    t0 = time.perf_counter()
    want = route_results(art, base, dev)
    mem_serve_s = time.perf_counter() - t0
    d = tempfile.mkdtemp(prefix="chip_smoke_artifact_", dir=tmp_root)
    try:
        rss_before_save = rss_now()
        t0 = time.perf_counter()
        art.save(d)
        save_s = time.perf_counter() - t0
        shard = checkpointer.Checkpointer(d).shard_path(0)
        file_bytes = os.path.getsize(shard)
        del art
        gc.collect()
        torch.cuda.empty_cache()
        rss_dropped = rss_now()
        t0 = time.perf_counter()
        loaded = CompressedModel.load(d, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        rss_load = rss_now()
        t0 = time.perf_counter()
        plan = CompressedExecutor(loaded, device=dev).step_plan(cfg32)
        for ps in plan.stages.values():
            device_stage(ps, dev)  # validation, block tables, upload
        torch.cuda.synchronize()
        plan_upload_s = time.perf_counter() - t0
        rss_upload = rss_now()
        pack_s = plan.pack_s
        if pack_s != 0.0 or plan.stages is not loaded.plans["step"]:
            fail(f"artifact: the plan was packed again ({pack_s} s), not read "
                 "from disk")
        del plan
        t0 = time.perf_counter()
        got = route_results(loaded, base, dev)
        disk_serve_s = time.perf_counter() - t0
        predicted = {"plan": 7 * cfg32.n_layers,
                     "per-region": (region_launches_per_step(base)
                                    + region_preps_per_step(base, loaded.records))}
        kernels = {"plan": set(PLAN), "per-region": set(PER_REGION)}
        for route, w in want.items():
            g = got[route]
            if g["tokens"] != w["tokens"]:
                fail(f"artifact {route}: the loaded artifact's tokens differ "
                     "from the in-memory serve's")
            if not torch.equal(g["logits"], w["logits"]):
                fail(f"artifact {route}: two-step logits differ from the "
                     "in-memory serve's")
            if (g["launches"] != w["launches"]
                    or g["launches_per_step"] != predicted[route]
                    or set(g["launches"]) != kernels[route]):
                fail(f"artifact {route}: {g['launches_per_step']} launches a "
                     f"step of {g['launches']}, in memory {w['launches']}, "
                     f"predicted {predicted[route]}")
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        # the reference's way, for comparison: one read() of the whole file,
        # then the same decoder, crc checks and conversion
        t0 = time.perf_counter()
        with open(shard, "rb") as f:
            buf = f.read()
        flat = checkpointer.unpack_payload(msgpack_codec.unpackb(buf))
        whole = CompressedModel.from_flat(flat, device=dev)
        torch.cuda.synchronize()
        read_load_s = time.perf_counter() - t0
        rss_read = rss_now()
        del whole, flat, buf
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return dict(phase="artifact", arch=base.name, layers=cfg32.n_layers,
                file_bytes=file_bytes, bytes_reckoned=total, save_s=save_s,
                load_s=load_s, plan_upload_s=plan_upload_s, pack_s=pack_s,
                read_load_s=read_load_s,
                rss_before_save=rss_before_save, rss_dropped=rss_dropped,
                rss_after_load=rss_load, rss_after_upload=rss_upload,
                rss_after_whole_read=rss_read,
                in_memory_serves_s=mem_serve_s, loaded_serves_s=disk_serve_s,
                routes={r: dict(launches_per_step=got[r]["launches_per_step"],
                                launches=got[r]["launches"],
                                ms_per_step=got[r]["ms_per_step"],
                                in_memory_ms_per_step=want[r]["ms_per_step"],
                                pack_s=got[r]["pack_s"],
                                tokens_equal=True, logits_bitwise=True,
                                sample_tokens=got[r]["tokens"][0][-16:])
                        for r in got},
                seconds=time.perf_counter() - t_phase)


# ------------------------- deepseek-v2-lite (MLA, shared experts, K9)


def kernel_case_moe_plan(label, plan, dev, timer, *, batch, serve=None):
    """K9 (``moe_plan_matmul``: stage A, SwiGLU, stage B) on one layer's
    expert plan at ``batch`` columns, held against its plain version within
    STEP_TOL (two stages and the SwiGLU in other orders).  The bound counts
    both stages' live terms, the input and the output once (the
    intermediates are the kernels' own); no single PyTorch call computes
    the function (the K6 rows carry the ``torch.bmm`` yardsticks)."""
    sa, sb = plan.stages["a"], plan.stages["b"]
    dff = plan.d_ff_total
    src = torch.randn((sa.d_src, batch), device=dev)
    y = moe_plan_matmul(sa, sb, d_ff_total=dff, src=src)
    torch.cuda.synchronize()
    plain = moe_plan_matmul_plain(sa, sb, d_ff_total=dff, src=src)
    err = check_close(f"{label} moe_plan_matmul", y, plain, STEP_TOL)
    del plain
    da, db = device_stage(sa, dev), device_stage(sb, dev)
    terms = da.live_terms[0] + db.live_terms[0]
    bytes_ = 6 * terms + 4 * batch * (sa.d_src + sb.out_dim)
    flops = 2 * terms * batch + 4 * dff * batch
    key = (sa.d_src, dff, sb.out_dim, batch)
    return kernel_row(
        "moe_plan_matmul", label,
        dict(D_src=sa.d_src, d_ff_total=dff, O=sb.out_dim, C=batch,
             live_terms=terms),
        key, err, False,
        lambda: moe_plan_matmul(sa, sb, d_ff_total=dff, src=src),
        lambda: moe_plan_matmul_plain(sa, sb, d_ff_total=dff, src=src), None,
        bound_of(bytes_, flops), timer, serve=serve)


def reduced_moe_plan_cases(cfg, dev, timer):
    """K9 and its stages on the reduced deepseek artifact (every site of
    ``attn.o`` and ``moe.up`` weight-shared): at the serve's 4 columns and
    at a ragged 5."""
    art = seeded_artifact(cfg, seed=6, device=dev)
    ex = CompressedExecutor(art, device=dev)
    plan = ex.moe_plan("l0", n_experts=cfg.moe.n_experts, d_model=cfg.d_model,
                       d_ff=cfg.moe.d_ff_expert)
    rng = np.random.default_rng(100)
    rows = []
    for batch in (4, 5):
        for name in ("a", "b"):
            rows.append(kernel_case_stage(f"reduced deepseek {name} C={batch}",
                                          plan.stages[name], rng, dev, timer,
                                          batch=batch))
        rows.append(kernel_case_moe_plan(f"reduced deepseek C={batch}", plan,
                                         dev, timer, batch=batch))
    return rows


def deepseek_region_cases(art, dev, timer, sm, serves):
    """The per-region kernels at the deepseek serves' own dimensions: layer
    0's MLA sites (K1 on q and o, K2 on dkv+kr at B = n_slots and on uk+uv
    over the whole latent view, B = n_slots x max_len), the shared experts
    (K2 gate+up, K1 down), each routed projection's experts as one K2
    launch of E at B = capacity, and K3's region prep on every region (bf16
    for the per-region serve; float32 for the K9 serve's MLA and shared
    experts).  The K1/K2 attention and shared-expert rows hold for both
    serves (``serves``: per-region name, K9 name); the expert rows for the
    per-region serve alone."""
    cfg = art.config
    ne = cfg.moe.n_experts
    cap = capacity(BATCH, cfg.moe.top_k, cfg.moe.capacity_factor, ne)
    rng = np.random.default_rng(110)
    pk = art.packed
    both = [kernel_case_chain(f"deepseek {site}", pk[f"{site}.l0"], rng, dev,
                              timer, sm)
            for site in ("attn.q", "attn.o", "moe.shared.down")]
    for label, names, batch in (
            ("attn.dkv+kr", ("attn.dkv", "attn.kr"), BATCH),
            ("attn.uk+uv latent view", ("attn.uk", "attn.uv"), BATCH * MAX_LEN),
            ("moe.shared.gate+up", ("moe.shared.gate", "moe.shared.up"), BATCH)):
        both.append(kernel_case_group(f"deepseek {label}",
                                      [pk[f"{n}.l0"] for n in names], rng, dev,
                                      timer, sm, batch=batch))
        torch.cuda.empty_cache()
    region = []
    for proj in ("gate", "up", "down"):
        region.append(kernel_case_group(
            f"deepseek moe.{proj} G={ne}",
            [pk[f"moe.{proj}.l0.e{e}"] for e in range(ne)], rng, dev, timer,
            sm, batch=cap))
        gc.collect()
        torch.cuda.empty_cache()
    # the bf16 serve's regions, and the K9 serve's per-region ones (MLA and
    # the shared experts) in float32
    region += region_cases(cfg, dev, timer, records=art.records)
    k9 = region_cases(cfg, dev, timer, records=art.records,
                      dtype=torch.float32,
                      keep=lambda n: not n[0].startswith(ROUTED))
    for row in region:
        row["serve"] = serves[0]
    out = region + [dict(row, serve=serves[1]) for row in k9]
    for row in both:
        out += [dict(row, serve=name) for name in serves]
    return out


def run_deepseek(dev):
    """deepseek-v2-lite-16b at full width, cut to DEEPSEEK_LAYERS layers:
    K9 on a reduced plan and the reduced serve (K9 route == per-region ==
    plain == dense, capacity drops occurring); the fixture, the per-region
    kernels at its shapes and the bf16 per-region serve (MLA through K1/K2,
    uk+uv over the whole latent view; experts as grouped K2 launches of 64;
    shared experts through K2 and K1); then one expert plan a layer packed
    and uploaded, K6 on every layer's stages A and B, K9 at layer 0's
    shapes, and the float32 serve on the K9 route; K9 vs per-region logits.
    Returns the kernel rows and the serves' launch counts."""
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    red = reduced_config(get_arch("deepseek-v2-lite-16b"), vocab=256)
    # capacity 4 for 8 slots x 2 choices over 4 experts: drops occur
    red = replace(red, moe=replace(red.moe, capacity_factor=0.5))
    rows = reduced_moe_plan_cases(red, dev, timer)
    emit(dict(phase="kernels", arch="deepseek-v2-lite-16b reduced",
              tolerance=SUM_TOL, step_tolerance=STEP_TOL, rows=rows))
    emit(phase_reduced_serve(dev, red, n_slots=8, n_prompts=8))
    torch.cuda.empty_cache()

    base, cfg32, art32, fixture_s = seeded_cut("deepseek-v2-lite-16b",
                                               DEEPSEEK_LAYERS, dev)
    ne, dff, d = base.moe.n_experts, base.moe.d_ff_expert, base.d_model

    region, k9 = f"{base.name} per-region", f"{base.name} K9"
    art16 = replace(art32, config=base, params=cast(art32.params, torch.bfloat16),
                    plans={})
    rows += deepseek_region_cases(art16, dev, timer, sm, (region, k9))
    full, counts, by_shape, eng = phase_full_serve(dev, base, art16, fixture_s,
                                                   ref_params=art32.params)
    full["host_peak_rss_bytes"] = host_peak_rss_bytes()
    emit(full)
    if full["plan_fallbacks"] != {"step": "mla", **{
            f"moe:l{li}": "cdtype" for li in range(base.n_layers)}}:
        fail(f"bf16 serve: plan fallbacks {full['plan_fallbacks']}")
    ex32 = CompressedExecutor(art32, use_plans=False, device=dev)
    ex32._groups = eng.executor._groups
    l_reg = two_step_logits(cfg32, art32, ex32, dev)
    serves = {region: (counts, by_shape, full["decode_steps"])}
    del eng, ex32, art16
    drop_per_region_copies(art32)

    # the K9 route: float32, one expert plan a layer
    ex = CompressedExecutor(art32, device=dev)
    plans = [ex.moe_plan(f"l{li}", n_experts=ne, d_model=d, d_ff=dff)
             for li in range(base.n_layers)]
    stages = [ps for plan in plans for ps in plan.stages.values()]
    pack_s = sum(plan.pack_s for plan in plans)
    t0 = time.perf_counter()
    # validation, block tables, upload: one stage a thread (a stage holds
    # one layer, so its own upload has no layers to spread over threads)
    with ThreadPoolExecutor(max_workers=len(stages)) as pool:
        list(pool.map(lambda ps: device_stage(ps, dev), stages))
    torch.cuda.synchronize()
    emit(dict(phase="fixture_and_plan", arch=base.name, pack_s=pack_s,
              upload_s=time.perf_counter() - t0,
              host_peak_rss_bytes=host_peak_rss_bytes(),
              stages={f"l{li}.{name}": dict(
                  shape=list(ps.gidx.shape), outg=list(ps.outg.shape),
                  k_alloc=ps.k_alloc,
                  slices=device_stage(ps, dev).dims["E"],
                  max_rows=device_stage(ps, dev).max_rows,
                  live_terms=sum(device_stage(ps, dev).live_terms),
                  stream_bytes=6 * ps.gidx.size, waste=ps.waste)
                  for li, plan in enumerate(plans)
                  for name, ps in plan.stages.items()}))
    cap = capacity(BATCH, base.moe.top_k, base.moe.capacity_factor, ne)
    checked = {}  # a row for each launch dimension; every stage held
    for li, plan in enumerate(plans):
        for name, kind in (("a", "eg"), ("b", "ed")):
            ps = plan.stages[name]
            mode = serve_mode(base, name)  # stage A gated, B plain
            kw, key_mode = mode_kwargs(ps, cap, mode, dev)
            key = device_stage(ps, dev).shape_key(cap, 1, key_mode)
            if key not in checked:
                rows.append(kernel_case_expert_stage(
                    f"deepseek l{li} {name}", kind, art32, ps, dev, timer,
                    batch=cap, serve=k9, wl=li, mode=mode))
                if mode:
                    rows[-1]["replaces"] = K9_REPLACES
                checked[key] = rows[-1]["shape"]
            else:  # the same dimensions as a row: the values still held
                src = dyadic(np.random.default_rng(li), (ps.d_src, cap), dev)
                err = check_close(f"deepseek l{li} {name}",
                                  stage_matmul(ps, src, layer=0, **kw),
                                  stage_matmul_plain(ps, src, layer=0, **kw),
                                  SUM_TOL)
                emit(dict(phase="kernel_check",
                          name=MODE_ROW[mode] if mode else "stage_matmul",
                          shape=f"deepseek l{li} {name}", max_abs_err=err,
                          row=checked[key]))
            gc.collect()
            torch.cuda.empty_cache()
    rows.append(kernel_case_moe_plan("deepseek l0", plans[0], dev, timer,
                                     batch=cap, serve=k9))
    del ex, plans
    # a layer: K1 q, o, shared down; K2 dkv+kr, uk+uv, shared gate+up; K9's
    # stage A (SwiGLU in its epilogue) and stage B; and a region prep for
    # each of the six per-region launches that prunes or shares (all six in
    # the fixture)
    preps = region_preps_per_step(base, art32.records,
                                  keep=lambda n: not n[0].startswith(ROUTED))
    planned, pcounts, pshape = phase_plan_serve(
        dev, cfg32, art32, stages, pack_s, l_reg=l_reg,
        predicted=8 * base.n_layers + preps,
        expected=set(PER_REGION) | {"stage_matmul"},
        n_plans=base.n_layers, fallbacks={"step": "mla"})
    planned["host_peak_rss_bytes"] = host_peak_rss_bytes()
    emit(planned)
    serves[k9] = (pcounts, pshape, planned["decode_steps"])
    return rows, serves


# ------------------------ the rest of the dense family and the VLM (A4)


def region_rows(art, dev, timer, sm, serve):
    """The per-region kernels at a dense or VLM serve's own dimensions
    (:func:`main_path_kernel_cases`: K1 on ``attn.o`` and ``ffn.down``, K2
    on q+k+v and gate+up, K3 on every region), named for the model and held
    to ``serve``'s launches."""
    rows = main_path_kernel_cases(art, dev, timer, sm)
    for row in rows:
        if row["shape"].startswith("full "):
            row["shape"] = art.config.name + row["shape"][4:]
        row["serve"] = serve
    return rows


def run_dense_arch(dev, arch, layers):
    """A dense-family model at full width cut to ``layers`` layers, on both
    routes (qwen2.5-3b with its q/k/v biases; llama3.2-3b and yi-9b under
    ``--only dense``): the fixture, the per-region kernels at its shapes
    and the bf16 per-region serve (``plan_fallbacks`` ``cdtype``); the
    plan packed and uploaded, K6 on its four stages (``qkv`` with a live
    bias where the model has one, gate+up gated), K7's norm and attention
    at its shapes and one whole step, and the float32 plan serve (7
    launches a layer) against the per-region route and the dense weights.
    Returns the kernel rows and the serves' launch counts."""
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    base, cfg32, art32, fixture_s = seeded_cut(arch, layers, dev)
    region, planned = f"{base.name} per-region", f"{base.name} plan"
    art16 = replace(art32, config=base, params=cast(art32.params, torch.bfloat16),
                    plans={})
    rows = region_rows(art16, dev, timer, sm, region)
    full, counts, by_shape, eng = phase_full_serve(dev, base, art16, fixture_s,
                                                   ref_params=art32.params)
    full["host_peak_rss_bytes"] = host_peak_rss_bytes()
    emit(full)
    if full["plan_fallbacks"] != {"step": "cdtype"}:
        fail(f"{base.name} bf16 serve: plan fallbacks {full['plan_fallbacks']}")
    ex32 = CompressedExecutor(art32, use_plans=False, device=dev)
    ex32._groups = eng.executor._groups
    l_reg = two_step_logits(cfg32, art32, ex32, dev)
    serves = {region: (counts, by_shape, full["decode_steps"])}
    del eng, ex32, art16
    drop_per_region_copies(art32)

    plan = CompressedExecutor(art32, device=dev).step_plan(cfg32)
    emit(upload_plan(base.name, plan, dev))
    stage_rows = main_path_stage_cases(art32, plan, dev, timer)
    for row in stage_rows:
        row["shape"] = base.name + row["shape"][4:]
        row["serve"] = planned
    qkv = stage_rows[0]
    if qkv["live_bias"] != base.qkv_bias:
        fail(f"{base.name} qkv stage: live bias {qkv['live_bias']}, the model "
             f"{'has' if base.qkv_bias else 'has no'} q/k/v biases")
    rows += stage_rows
    rng = np.random.default_rng(70)
    rows.append(kernel_case_norm(cfg32, dev, timer, serve=planned))
    rows.append(kernel_case_attention(
        f"{base.name} serve S={MAX_LEN}", cfg32, MAX_LEN, cfg32.attn_window,
        serve_positions(rng), dev, timer, serve=planned))
    rows.append(kernel_case_step(f"{base.name} step", cfg32, plan, rng, dev,
                                 timer, serve=planned))
    torch.cuda.empty_cache()
    line, pcounts, pshape = phase_plan_serve(dev, cfg32, art32,
                                             plan.stages.values(), plan.pack_s,
                                             l_reg=l_reg)
    line["host_peak_rss_bytes"] = host_peak_rss_bytes()
    emit(line)
    serves[planned] = (pcounts, pshape, line["decode_steps"])
    return rows, serves


def run_vlm(dev, layers=QWEN_LAYERS):
    """qwen2-vl-7b at full width cut to ``layers`` layers: m-RoPE refuses
    the whole-step plan (``pos:mrope``, as in the reference), so both of
    its engines serve per-region — bf16, and float32, whose engine must
    report that fallback.  The per-region kernels at its shapes (K2 q+k+v
    with k and v padded to q's 3584 rows, gate+up at 18944 rows, K1 ``o``
    and ``down`` at K 18944, K3 on every region in both dtypes), both
    serves (the prefix cache off), and the float32 route's two-step logits
    against the dense float32 weights.  Returns the kernel rows and the
    serves' launch counts."""
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    base, cfg32, art32, fixture_s = seeded_cut("qwen2-vl-7b", layers, dev)
    region, region32 = f"{base.name} per-region", f"{base.name} per-region f32"
    art16 = replace(art32, config=base, params=cast(art32.params, torch.bfloat16),
                    plans={})
    rows = region_rows(art16, dev, timer, sm, region)
    rows += [dict(row, serve=region32) for row in rows
             if row["name"] != "region_prep"]
    rows += region_cases(cfg32, dev, timer, records=art32.records,
                         dtype=torch.float32, serve=region32)
    serves, lines, engines = {}, {}, {}
    for name, cfg, art in ((region, base, art16), (region32, cfg32, art32)):
        line, counts, by_shape, eng = phase_full_serve(
            dev, cfg, art, fixture_s, ref_params=art32.params)
        line.update(prefix_cache=eng.pool.prefix_cache,
                    n_layer_plans=eng.n_layer_plans,
                    host_peak_rss_bytes=host_peak_rss_bytes())
        emit(line)
        if (line["plan_fallbacks"] != {"step": "pos:mrope"}
                or eng.n_layer_plans or eng.pool.prefix_cache):
            fail(f"{name} serve: plan fallbacks {line['plan_fallbacks']}, "
                 f"{eng.n_layer_plans} plans, prefix cache "
                 f"{eng.pool.prefix_cache}; m-RoPE takes the per-region route "
                 "with the prefix cache off")
        serves[name] = (counts, by_shape, line["decode_steps"])
        lines[name] = line
        engines[name] = eng.executor
    # the two routes' logits against the dense float32 weights: two decode
    # steps from a fresh cache (text positions on all three m-RoPE axes)
    l32 = two_step_logits(cfg32, art32, engines[region32], dev)
    l16 = two_step_logits(base, art16, engines[region], dev)
    del engines
    torch.cuda.empty_cache()
    l_dense = two_step_logits(cfg32, art32, None, dev)
    scale = max(1.0, float(l_dense.abs().max()))
    err32 = float((l32 - l_dense).abs().max()) / scale
    err16 = float((l16 - l_dense).abs().max()) / scale
    emit(dict(phase="vlm_routes", arch=base.name,
              float32_vs_dense=err32, route_tol=ROUTE_TOL, bf16_vs_dense=err16,
              launches_per_step={n: lines[n]["launches_per_step"] for n in lines},
              plan_fallbacks=lines[region32]["plan_fallbacks"]))
    if not err32 <= ROUTE_TOL or not bool(torch.isfinite(l16).all()):
        fail(f"{base.name}: float32 per-region logits {err32} off the dense "
             f"weights (tolerance {ROUTE_TOL}), or bf16 logits not finite")
    return rows, serves


def run_qwen(dev):
    """qwen2.5-3b on both routes, then qwen2-vl-7b per-region, each at full
    width cut to QWEN_LAYERS layers."""
    rows, serves = run_dense_arch(dev, "qwen2.5-3b", QWEN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    vrows, vserves = run_vlm(dev)
    return rows + vrows, {**serves, **vserves}


def run_dense(dev):
    """``--only dense``: llama3.2-3b and yi-9b on both routes at full width,
    cut to DENSE_LAYERS layers."""
    rows, serves = [], {}
    for arch in ("llama3.2-3b", "yi-9b"):
        r, sv = run_dense_arch(dev, arch, DENSE_LAYERS)
        rows += r
        serves.update(sv)
        gc.collect()
        torch.cuda.empty_cache()
    return rows, serves


# ------------------------------- the recurrent families (ssm and hybrid)


def region_kernel_cases(art, dev, timer, sm, serve):
    """K1 and K2 on every region of layer 0 and of the hybrid's shared
    block (the fixture's own packed decompositions, grouped as the executor
    groups them: rwkv6's r+k+v+g and k+r, the shared block's q+k+v and
    gate+up, whisper's decoder q+k+v), once a launch shape (whisper's
    attn.o and xattn.q share theirs: one row, both names in its label), K3
    on each region in the serve's dtype, all held to ``serve``'s
    launches."""
    cfg = art.config
    rng = np.random.default_rng(20)
    rows, seen = [], {}
    for names in site_groups(cfg) + shared_groups(cfg):
        label = f"{cfg.name} " + "+".join(region_site(n) for n in names)
        pk = [art.packed[n] for n in names]
        key = (*pk[0].idx.shape, pk[0].in_dim) if len(pk) == 1 else None
        if key in seen:
            seen[key]["shape"] += "|" + region_site(names[0])
            continue
        rows.append(kernel_case_chain(label, pk[0], rng, dev, timer, sm)
                    if len(pk) == 1 else
                    kernel_case_group(label, pk, rng, dev, timer, sm))
        if key is not None:
            seen[key] = rows[-1]
        torch.cuda.empty_cache()
    rows += region_cases(cfg, dev, timer, records=art.records,
                         dtype=cfg.cdtype)
    for row in rows:
        row["serve"] = serve
    return rows


def run_recurrent_arch(dev, arch, layers, bf16: bool):
    """A recurrent model at full width cut to ``layers`` layers, served on
    the per-region route (both families refuse the whole-step plan,
    ``family:ssm`` / ``family:hybrid``, as in the reference) in float32 and,
    with ``bf16``, in bf16 too, tokenwise prefill into 8 slots: K1/K2/K3 at
    every region's shapes in the serve's dtype, the serves, and the float32
    route's two-step logits against the dense float32 weights within
    STEP_TOL.  Returns the kernel rows and the serves' launch counts."""
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    base, cfg32, art32, fixture_s = seeded_cut(arch, layers, dev)
    region, region32 = f"{base.name} per-region", f"{base.name} per-region f32"
    rows = region_kernel_cases(art32, dev, timer, sm, region32)
    routes = [(region32, cfg32, art32)]
    if bf16:
        art16 = replace(art32, config=base,
                        params=cast(art32.params, torch.bfloat16), plans={})
        rows += [dict(row, serve=region) for row in rows
                 if row["name"] != "region_prep"]
        rows += [dict(row, serve=region) for row in region_cases(
            base, dev, timer, records=art16.records, dtype=torch.bfloat16)]
        routes.append((region, base, art16))
    serves, lines, engines = {}, {}, {}
    refusal = {"step": f"family:{base.family}"}
    for name, cfg, art in routes:
        line, counts, by_shape, eng = phase_full_serve(
            dev, cfg, art, fixture_s, ref_params=art32.params)
        kinds = set(line["prefill_kinds"])
        line.update(pool=eng.pool is not None, n_layer_plans=eng.n_layer_plans,
                    host_peak_rss_bytes=host_peak_rss_bytes())
        emit(line)
        print(f"{name}: plan refused, {line['plan_fallbacks']}", flush=True)
        if (line["plan_fallbacks"] != refusal or eng.n_layer_plans
                or kinds != {"tokenwise"} or eng.pool is not None):
            fail(f"{name} serve: plan fallbacks {line['plan_fallbacks']}, "
                 f"{eng.n_layer_plans} plans, prefill {sorted(kinds)}, pool "
                 f"{eng.pool is not None}; a recurrent family takes the "
                 "per-region route and prefills token by token into its "
                 "contiguous state")
        # the serve's launches came from its decode steps and the tokenwise
        # prefill's, each one step of the same kernels
        serves[name] = (counts, by_shape,
                        line["decode_steps"] + line["prefill_steps"])
        lines[name] = line
        engines[name] = eng.executor
    l32 = two_step_logits(cfg32, art32, engines[region32], dev)
    l16 = (two_step_logits(base, art16, engines[region], dev) if bf16
           else None)
    del engines
    torch.cuda.empty_cache()
    l_dense = two_step_logits(cfg32, art32, None, dev)
    scale = max(1.0, float(l_dense.abs().max()))
    err32 = float((l32 - l_dense).abs().max()) / scale
    err16 = (None if l16 is None
             else float((l16 - l_dense).abs().max()) / scale)
    emit(dict(phase="recurrent_routes", arch=base.name, layers=base.n_layers,
              float32_vs_dense=err32, step_tol=STEP_TOL, bf16_vs_dense=err16,
              launches_per_step={n: lines[n]["launches_per_step"] for n in lines},
              plan_fallbacks=lines[region32]["plan_fallbacks"]))
    if not err32 <= STEP_TOL or (l16 is not None
                                 and not bool(torch.isfinite(l16).all())):
        fail(f"{base.name}: float32 per-region logits {err32} off the dense "
             f"weights (tolerance {STEP_TOL}), or bf16 logits not finite")
    return rows, serves


def run_recurrent(dev, bf16: bool):
    """rwkv6-1.6b (ssm) cut to RWKV_LAYERS layers, then zamba2-7b (hybrid)
    cut to ZAMBA_LAYERS (one group of six mamba layers, the shared block,
    one tail layer), each at full width on the per-region route in float32
    and, with ``bf16`` (``--only recurrent``; the full run leaves it out
    for time), in bf16 too."""
    rows, serves = run_recurrent_arch(dev, "rwkv6-1.6b", RWKV_LAYERS, bf16)
    gc.collect()
    torch.cuda.empty_cache()
    zrows, zserves = run_recurrent_arch(dev, "zamba2-7b", ZAMBA_LAYERS, bf16)
    return rows + zrows, {**serves, **zserves}


# ----------------------------------------- whisper-small (the audio family)


def whisper_frames(cfg, slot, dev):
    """Slot ``slot``'s seeded encoder input: WHISPER_ENC frame embeddings
    of ``d_model``, drawn on the card (another set for every slot)."""
    g = torch.Generator(device=dev).manual_seed(1000 + slot)
    return torch.randn((WHISPER_ENC, cfg.d_model), generator=g, device=dev)


def fill_slots(art, cfg, state, dev) -> None:
    """Every slot's static cross-KV from the port's encoder over the slot's
    own frames (``testing.fill_cross_kv``, the reference's recipe), on the
    artifact's dense-effective weights."""
    for slot in range(state["cross_k"].shape[1]):
        fill_cross_kv(art.params, cfg, state, slot,
                      whisper_frames(cfg, slot, dev))


def decoder_routed(sites) -> set:
    """The sites a whisper decode step routes (the reference's rule): the
    decoder's, without ``dec.xattn.k/v`` (their KV is static); the
    encoder's run in no step."""
    return {n for n in sites if n.startswith("dec.")
            and not n.startswith(("dec.xattn.k.", "dec.xattn.v."))}


def run_audio(dev, full: bool):
    """whisper-small (the encoder-decoder) at full width, cut to
    WHISPER_LAYERS encoder and decoder layers in the full run and uncut
    with ``full`` (``--only audio``), on the per-region route (the plan is
    refused with ``encoder_decoder``, as in the reference) in float32 and,
    with ``full``, in bf16 too: 8 slots over whisper's 30-second window
    (``max_len`` = WHISPER_ENC encoder positions), each slot's cross-KV
    filled from the port's encoder over its own seeded frames before the
    serve and unchanged after it (and after the profiled steps), tokenwise
    prefill into the contiguous state, ``routed`` the decoder's sites but
    xattn.k/v; K1/K2/K3 at every launch shape of the six decoder regions
    bit for bit; the float32 route's two-step logits against the dense
    float32 weights within STEP_TOL.  Returns the kernel rows and the
    serves' launch counts."""
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    layers = get_arch("whisper-small").n_layers if full else WHISPER_LAYERS
    base, cfg32, art32, fixture_s = seeded_cut("whisper-small", layers, dev,
                                               enc_layers=layers)
    region, region32 = f"{base.name} per-region", f"{base.name} per-region f32"
    rows = region_kernel_cases(art32, dev, timer, sm, region32)
    routes = [(region32, cfg32, art32)]
    if full:
        art16 = replace(art32, config=base,
                        params=cast(art32.params, torch.bfloat16), plans={})
        rows += [dict(row, serve=region) for row in rows
                 if row["name"] != "region_prep"]
        rows += [dict(row, serve=region) for row in region_cases(
            base, dev, timer, records=art16.records, dtype=torch.bfloat16)]
        routes.append((region, base, art16))
    serves, lines, engines = {}, {}, {}
    refusal = {"step": "encoder_decoder"}
    for name, cfg, art in routes:
        held = {}

        def setup(eng, cfg=cfg, art=art, held=held):
            t0 = time.perf_counter()
            fill_slots(art, cfg, eng.state, dev)
            torch.cuda.synchronize()
            held.update(fill_s=time.perf_counter() - t0,
                        kv={n: eng.state[n].clone()
                            for n in ("cross_k", "cross_v")})

        line, counts, by_shape, eng = phase_full_serve(
            dev, cfg, art, fixture_s, ref_params=art32.params,
            max_len=WHISPER_ENC, setup=setup, routed=decoder_routed)
        kinds = set(line["prefill_kinds"])
        kept = all(torch.equal(eng.state[n], v) for n, v in held["kv"].items())
        line.update(pool=eng.pool is not None, n_layer_plans=eng.n_layer_plans,
                    enc_layers=cfg.enc_layers, cross_kv_fill_s=held["fill_s"],
                    cross_kv_unchanged=kept,
                    host_peak_rss_bytes=host_peak_rss_bytes())
        emit(line)
        print(f"{name}: plan refused, {line['plan_fallbacks']}", flush=True)
        if (line["plan_fallbacks"] != refusal or eng.n_layer_plans
                or kinds != {"tokenwise"} or eng.pool is not None or not kept):
            fail(f"{name} serve: plan fallbacks {line['plan_fallbacks']}, "
                 f"{eng.n_layer_plans} plans, prefill {sorted(kinds)}, pool "
                 f"{eng.pool is not None}, cross-KV unchanged {kept}; the "
                 "encoder-decoder takes the per-region route, prefills token "
                 "by token into its contiguous state and keeps the cross-KV "
                 "its caller wrote")
        serves[name] = (counts, by_shape,
                        line["decode_steps"] + line["prefill_steps"])
        lines[name] = line
        engines[name] = eng.executor
        del eng, held
        torch.cuda.empty_cache()

    def filled(art, cfg):
        return lambda st: fill_slots(art, cfg, st, dev)

    kw = dict(smax=WHISPER_ENC)
    l32 = two_step_logits(cfg32, art32, engines[region32], dev,
                          setup=filled(art32, cfg32), **kw)
    l16 = (two_step_logits(base, art16, engines[region], dev,
                           setup=filled(art16, base), **kw) if full else None)
    del engines
    torch.cuda.empty_cache()
    l_dense = two_step_logits(cfg32, art32, None, dev,
                              setup=filled(art32, cfg32), **kw)
    scale = max(1.0, float(l_dense.abs().max()))
    err32 = float((l32 - l_dense).abs().max()) / scale
    err16 = (None if l16 is None
             else float((l16 - l_dense).abs().max()) / scale)
    emit(dict(phase="audio_routes", arch=base.name, layers=base.n_layers,
              enc_layers=base.enc_layers, enc_len=WHISPER_ENC,
              float32_vs_dense=err32, step_tol=STEP_TOL, bf16_vs_dense=err16,
              launches_per_step={n: lines[n]["launches_per_step"] for n in lines},
              plan_fallbacks=lines[region32]["plan_fallbacks"]))
    if not err32 <= STEP_TOL or (l16 is not None
                                 and not bool(torch.isfinite(l16).all())):
        fail(f"{base.name}: float32 per-region logits {err32} off the dense "
             f"weights (tolerance {STEP_TOL}), or bf16 logits not finite")
    return rows, serves


# ------------------------------------------- K4: the per-factor route


def factor_bound(idx, sign, k, b):
    """(bound_ms, bound_by) of one factor: its live terms' streams (6 bytes
    each), x [K, B] and y [N, B] float32 once; 2 operations a live term and
    column."""
    terms = int((sign != 0).sum())
    return bound_of(6 * terms + 4 * b * (k + idx.shape[0]), 2 * terms * b)


def phase_factor_route(dev, art, timer):
    """K4 (``lcc_factor_matmul``) on layer 0's ``attn.o`` and ``ffn.down``
    of the full-width olmo artifact at B = n_slots: every real factor of
    every slice held against its plain version bit for bit on dyadic input,
    float32 and (once a dimension) bf16; then the per-factor route
    (``ops.apply_packed_decomposition(..., fused=False)``, one launch a real
    factor), its launches counted from 0, held against fused K1 within
    SUM_TOL and timed beside it (the reference's ``speedup_from_fusion``).  Returns the kernel rows (one per
    launch dimension) and the route's ``(counts, by_shape, 1)``."""
    rng = np.random.default_rng(90)
    sites = {name: art.packed[f"{name}.l0"] for name in ("attn.o", "ffn.down")}
    cases = {}  # (N, S, K, B) -> [(site, e, p)]
    for name, pk in sites.items():
        ds = pk.on(dev)
        for e, (c0, c1) in enumerate(pk.col_slices):
            for p in range(pk.chain_lengths[e]):
                k = c1 - c0 if p == 0 else pk.idx.shape[2]
                args = (ds.idx[e, p], ds.exp[e, p], ds.sign[e, p])
                x = dyadic(rng, (k, BATCH), dev)
                y = lcc_factor_matmul(*args, x)
                if not torch.equal(y, lcc_factor_matmul_plain(*args, x)):
                    fail(f"lcc_factor_matmul {name} slice {e} factor {p}: "
                         "kernel differs from the plain version on dyadic "
                         "input")
                key = (pk.idx.shape[2], pk.idx.shape[3], k, BATCH)
                if key not in cases:  # bf16 activations once a dimension
                    x16 = x.to(torch.bfloat16)
                    if not torch.equal(lcc_factor_matmul(*args, x16),
                                       lcc_factor_matmul_plain(*args, x16)):
                        fail(f"lcc_factor_matmul {name} slice {e} factor {p}: "
                             "kernel differs from the plain version on bf16 "
                             "dyadic input")
                cases.setdefault(key, []).append((name, e, p))
    torch.cuda.synchronize()
    xs = {name: torch.randn((pk.in_dim, BATCH), device=dev)
          for name, pk in sites.items()}
    dispatch.reset_launch_count()  # counts of the per-factor route ...
    ys = {name: ops.apply_packed_decomposition(pk, xs[name], fused=False)
          for name, pk in sites.items()}
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()  # ... read here
    by_shape = dispatch.launch_counts_by_shape()
    want = sum(sum(pk.chain_lengths) for pk in sites.values())
    if counts != {"lcc_factor_matmul": want}:
        fail(f"per-factor route: launched {counts}, expected {want} "
             "lcc_factor_matmul launches (the chains' real factors)")
    route = {}
    for name, pk in sites.items():
        fused = ops.apply_packed_decomposition(pk, xs[name])
        err = check_close(f"per-factor route {name} vs fused", ys[name], fused,
                          SUM_TOL)
        per_ms = timer(lambda: ops.apply_packed_decomposition(
            pk, xs[name], fused=False))
        fused_ms = timer(lambda: ops.apply_packed_decomposition(pk, xs[name]))
        route[name] = dict(E=len(pk.col_slices), launches=sum(pk.chain_lengths),
                           max_abs_err_vs_fused=err, per_factor_ms=per_ms,
                           fused_ms=fused_ms, per_factor_over_fused=per_ms / fused_ms)
    emit(dict(phase="factor_route", arch=art.config.name, B=BATCH, sites=route,
              tolerance=SUM_TOL))
    rows = []
    for key, where in sorted(cases.items()):
        n, s, k, b = key
        name, e, p = where[0]
        ds = sites[name].on(dev)
        args = (ds.idx[e, p], ds.exp[e, p], ds.sign[e, p])
        x = dyadic(rng, (k, b), dev)
        dense = lcc_factor_dense_ref(*args, k)
        rows.append(kernel_row(
            "lcc_factor_matmul", f"olmo per-factor N={n} K={k}",
            dict(N=n, S=s, K=k, B=b, factors_checked=len(where)), key, 0.0,
            True, lambda: lcc_factor_matmul(*args, x),
            lambda: lcc_factor_matmul_plain(*args, x),
            lambda: torch.matmul(dense, x),
            factor_bound(sites[name].idx[e, p], sites[name].sign[e, p], k, b),
            timer, serve=FACTOR_ROUTE))
    return rows, (counts, by_shape, 1)


# ---------------------------------------------- training (K5, group_prox)

# K5 |kernel - plain| <= PROX_TOL * max(1, max|plain|) in float32: the row's
# sum of squares in another order; bf16: one bf16 ulp of the plain version's
# value (the same float32 product rounded once on either side) plus
# PROX_TOL * |a|: the two float32 scales differ by up to ~1e-6, which near
# the threshold (scale ~1e-4 and below) is more than an ulp of the output
PROX_TOL = 1e-6
PROX_MARGIN = 1e-5  # killed rows must agree where |norm - t| / t > this
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_LR, TRAIN_LAM = 3e-3, 0.1  # the launcher's defaults
TRAIN_STEPS = 5  # timed, after one warm step


def bf16_ulp(w: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``w`` (8 significant bits)."""
    _, e = torch.frexp(w.float().abs())
    return torch.ldexp(torch.ones_like(w, dtype=torch.float32), e - 8)


def check_prox(label, got, want, a, t):
    """K5's result against a reference of the same prox: the tolerance of
    its dtype, and the same killed rows wherever the row's norm is not within
    PROX_MARGIN of the threshold.  Returns (max_abs_err, smallest margin)."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if got.dtype == torch.float32:
        check_close(label, got, want, PROX_TOL)
    else:
        over = diff - bf16_ulp(want) - PROX_TOL * a.float().abs()
        if bool((over > 0).any()):
            i = int(torch.argmax(over))
            r, c = divmod(i, a.shape[1])
            nr = float(torch.linalg.vector_norm(a[r], dtype=torch.float32))
            fail(f"{label}: beyond one bf16 ulp + {PROX_TOL}*|a| of the plain "
                 f"version at [{r}, {c}]: a {float(a[r, c])}, got "
                 f"{float(got[r, c])}, want {float(want[r, c])}, row norm "
                 f"{nr}, t {t} (max_abs_err {err:.3e})")
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite output")
    norms = torch.linalg.vector_norm(a, dim=1, dtype=torch.float32)
    margin = ((norms - t).abs() / t if t > 0
              else torch.full_like(norms, float("inf")))
    away = margin > PROX_MARGIN
    differ = ((got == 0).all(1) != (want == 0).all(1)) & away
    if bool(differ.any()):
        fail(f"{label}: {int(differ.sum())} rows killed on one side only")
    ulp = {}
    if got.dtype != torch.float32:  # where one ulp alone is not enough
        rows = (diff > bf16_ulp(want)).any(1)
        ulp = dict(rows_beyond_one_ulp=int(rows.sum()),
                   their_largest_margin=float(margin[rows].max())
                   if bool(rows.any()) else None)
    return err, float(margin.min()), ulp


def prox_input(rng, g, m, dtype, dev):
    """Rows of unequal norm (scaled by 0.5-1.5) with every 97th row zero,
    and a threshold that kills about half of them."""
    a = rng.standard_normal((g, m), dtype=np.float32)
    a *= rng.uniform(0.5, 1.5, (g, 1)).astype(np.float32)
    a[::97] = 0.0
    t = torch.from_numpy(a).to(dev, dtype)
    return t, mid_threshold(torch.linalg.vector_norm(t, dim=1, dtype=torch.float32))


def mid_threshold(norms: torch.Tensor) -> float:
    """Halfway between the two middle group norms: about half the groups
    die, and no group sits exactly on the threshold."""
    s = torch.sort(norms).values
    return float(s[(len(s) - 1) // 2] + s[len(s) // 2]) / 2


def kernel_case_prox(label, a, t, dev, timer, serve=None):
    """K5 on ``a`` at threshold ``t``: against the plain version and the
    oracle, bitwise from run to run and in place == out of place; timed
    (bound: the view read and written once, three operations a weight)."""
    g, m = a.shape
    got = group_prox(a, t)
    want = group_prox_plain(a, t)
    err, margin, ulp = check_prox(f"group_prox {label}", got, want, a, t)
    check_prox(f"group_prox {label} (oracle)", got, group_prox_ref(a, t), a, t)
    if not torch.equal(group_prox(a, t), got):
        fail(f"group_prox {label}: two runs differ")
    inplace = a.clone()
    group_prox(inplace, t, out=inplace)
    if not torch.equal(inplace, got):
        fail(f"group_prox {label}: in place differs from out of place")
    torch.cuda.synchronize()
    out = torch.empty_like(a)
    killed = int((got == 0).all(1).sum())
    return kernel_row("group_prox", label, [g, m], (g, m), err, None,
                      lambda: group_prox(a, t, out=out),
                      lambda: group_prox_plain(a, t), None,
                      bound_of(2 * a.numel() * a.element_size(), 3 * a.numel()),
                      timer, serve=serve, dtype=str(a.dtype).split(".")[-1],
                      killed_rows=killed, smallest_margin=margin, **ulp,
                      library_note="none: no single PyTorch call computes "
                                   "the prox")


def olmo_prox_views(cfg):
    """The [G, M] views of olmo-1b's seven regularized leaves (all in_rows:
    the leaf [L, K, N] viewed as [L*K, N]), grouped by shape."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    return {"attn.q/k/v/o": (L * d, cfg.n_heads * cfg.hd),
            "ffn.gate/up": (L * d, f), "ffn.down": (L * f, d)}


def phase_train_kernels(dev, cfg):
    """K5 on the reference's hard cases, rows of every width up to 16384 in
    float32 and bf16, then the main paths' own views: olmo-1b's (bf16) and
    the MLP's (float32, transposed copies of fc1 [300, 784] and fc2)."""
    timer = Timer(dev)
    rng = np.random.default_rng(60)
    rows = []
    hard = np.random.default_rng(5).standard_normal((37, 16)).astype(np.float32)
    hard[[3, 17, 36]] = 0.0
    for r, n in ((5, 2.0), (9, 1.995), (11, 2.005)):  # at, under, over t = 2
        hard[r] *= n / np.linalg.norm(hard[r])
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        rows.append(kernel_case_prox(f"hard 37x16 {name} t=2",
                                     torch.from_numpy(hard).to(dev, dt), 2.0,
                                     dev, timer))
        for m in (10, 33, 300, 2047, 2048, 8192, 16384):
            a, t = prox_input(rng, 1003, m, dt, dev)
            rows.append(kernel_case_prox(f"1003x{m} {name}", a, t, dev, timer))
        a, _ = prox_input(rng, 1003, 300, dt, dev)
        rows.append(kernel_case_prox(f"1003x300 {name} t=0", a, 0.0, dev, timer))
    torch.cuda.empty_cache()
    for leaves, (g, m) in olmo_prox_views(cfg).items():
        a, t = prox_input(rng, g, m, torch.bfloat16, dev)
        rows.append(kernel_case_prox(f"full olmo {leaves} [{g}, {m}] bf16", a, t,
                                     dev, timer, serve=f"{cfg.name} train"))
        del a
        torch.cuda.empty_cache()
    for leaf, (g, m) in (("fc1", (784, 300)), ("fc2", (300, 10))):
        a, t = prox_input(rng, g, m, torch.float32, dev)
        rows.append(kernel_case_prox(f"full mlp {leaf} [{g}, {m}] float32", a, t,
                                     dev, timer, serve="mlp train"))
    return rows


# device kernels by class, for where a train step's time goes (name fragments)
KERNEL_CLASSES = (("group_prox (K5)", ("group_prox_kernel",)),
                  ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
                  ("softmax", ("softmax",)),
                  ("reduction", ("reduce_kernel",)),
                  ("index / scatter / gather", ("index", "scatter", "gather",
                                                "embedding")),
                  ("elementwise", ("elementwise",)),
                  ("copy / fill", ("copy", "Memcpy", "Memset", "fill")))


def profile_train_step(cfg, opt, specs, state, batch):
    """Where one steady train step's time goes: CUDA events around the
    optimizer's update (the rest of the step is forward + backward + clip
    before it and the sparsity report after it) in one step, then
    torch.profiler's device time by kernel name and class in the next; K5's
    share, and the device's idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.training.trainer import make_train_step

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def timed_update(*a):
        ev[1].record()
        out = opt.update(*a)
        ev[2].record()
        return out

    step_fn = make_train_step(cfg, Optimizer(opt.init, timed_update),
                              lr=TRAIN_LR, prox_specs=specs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    state, _ = step_fn(state, batch)
    ev[3].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events_ms = dict(forward_backward_clip=ev[0].elapsed_time(ev[1]),
                     optimizer_update=ev[1].elapsed_time(ev[2]),
                     sparsity_report=ev[2].elapsed_time(ev[3]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    by_name, counts = device_ms_by_name(prof)
    launched = sum(counts.values())
    busy = sum(by_name.values())
    if busy <= 0:
        fail("the profiler reported no device time for the train step")
    by_class = {}
    for name, ms in by_name.items():
        cls = next((c for c, frags in KERNEL_CLASSES
                    if any(f in name for f in frags)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    k5 = by_class.get("group_prox (K5)", 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return state, dict(
        wall_ms=wall_ms, device_busy_ms=busy,
        device_idle_share=max(0.0, 1.0 - busy / wall_ms),
        events_ms=events_ms,
        device_kernels=launched, group_prox_device_ms=k5,
        group_prox_share_of_busy=k5 / busy,
        device_ms_by_class={k: round(v, 4) for k, v in
                            sorted(by_class.items(), key=lambda kv: -kv[1])},
        top_device_ms={k.removeprefix("void ")[:110]: round(v, 4)
                       for k, v in top})


def check_update_routes(state, specs, step_batch, cfg, dev):
    """One ProxSGD update on the same parameters, gradients and momentum
    through K5 (``use_kernel=True``) and through the XLA-equivalent route
    (``use_kernel=False``: ``group_prox_rows`` in bf16, as the reference's):
    parameters within one bf16 ulp and the same dead groups.  Then the same
    pre-prox parameters at a threshold that kills about half of each
    leaf's groups, K5 against its float32 plain version."""
    from repro_torch.optim.optimizers import (apply_spec_prox, clip_by_global_norm,
                                              sgd, spec_group_norms, tree_get,
                                              tree_leaves, tree_map)

    params = state.params
    leaves = tree_leaves(params)
    loss = api.train_loss(params, cfg, step_batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    grads, _ = clip_by_global_norm(tree_map(lambda _: next(it), params), 1.0)
    with torch.no_grad():
        pre = tree_map(lambda p: p.detach().clone(), params)
        mu = tree_map(lambda m: m.clone(), state.opt_state["mu"])
        sgd(0.9).update(grads, {"mu": mu}, pre, TRAIN_LR)  # prox_sgd's first half
        del mu, grads
        out = dict(launches=0)
        for tag, thresh in (("run", lambda n: TRAIN_LR * TRAIN_LAM),
                            ("median", mid_threshold)):
            worst, dead_k, dead_x, margin = 0.0, 0, 0, float("inf")
            for gs in specs:
                leaf = tree_get(pre, gs.path)
                norms = spec_group_norms(leaf, gs.kind)
                t = thresh(norms)
                n0 = dispatch.launch_count("group_prox")
                k = apply_spec_prox(leaf.clone(), gs.kind, t, use_kernel=True)
                out["launches"] += dispatch.launch_count("group_prox") - n0
                if tag == "run":
                    x = apply_spec_prox(leaf.clone(), gs.kind, t, use_kernel=False)
                else:  # the bf16 XLA route rounds the scale itself: plain f32
                    x = group_prox_plain(leaf.reshape(-1, leaf.shape[-1]), t
                                         ).reshape(leaf.shape)
                k2, x2 = k.reshape(-1, k.shape[-1]), x.reshape(-1, x.shape[-1])
                err, m, _ = check_prox(f"train update {gs.name} ({tag})", k2,
                                       x2, leaf.reshape(-1, leaf.shape[-1]), t)
                worst, margin = max(worst, err), min(margin, m)
                dead_k += int((spec_group_norms(k, gs.kind) == 0).sum())
                dead_x += int((spec_group_norms(x, gs.kind) == 0).sum())
                del k, x, k2, x2
            if margin > PROX_MARGIN and dead_k != dead_x:  # else: row by row
                fail(f"train update ({tag}): {dead_k} dead groups through K5, "
                     f"{dead_x} through the other route")
            out[tag] = dict(max_abs_err=worst, dead_groups=dead_k,
                            smallest_margin=margin)
    del pre
    torch.cuda.empty_cache()
    return out


def checkpoint_round_trip(state, step_fn, batch, specs) -> dict:
    """The full-width train state through the Checkpointer: a blocking save,
    ``restore_latest`` into a fresh state of the same structure (every leaf
    bitwise what was saved, on the same device in the same dtype), then one
    step from the restored state: K5 once a spec, a finite loss."""
    import dataclasses
    import tempfile

    from repro_torch.optim.optimizers import tree_map

    step = int(state.step)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        ck = checkpointer.Checkpointer(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(step, state, blocking=True)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(ck.shard_path(step))
        fresh = dataclasses.replace(
            state, params=tree_map(torch.empty_like, state.params),
            opt_state=tree_map(torch.empty_like, state.opt_state),
            step=torch.empty_like(state.step),
            prox_report=tree_map(torch.empty_like, state.prox_report))
        t0 = time.perf_counter()
        got, restored = ck.restore_latest(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    saved = _flatten(state)
    back = _flatten(restored)
    bad = [k for k, v in saved.items()
           if not (back[k].dtype == v.dtype and back[k].device == v.device
                   and torch.equal(back[k], v))]
    if got != step or list(back) != list(saved) or bad:
        fail(f"train checkpoint: restored step {got} of {step}, leaves "
             f"differing: {bad[:5]}")
    n0 = dispatch.launch_count("group_prox")
    restored, m = step_fn(restored, batch)
    loss = float(m["loss"])
    launches = dispatch.launch_count("group_prox") - n0
    if not np.isfinite(loss) or launches != len(specs):
        fail(f"train checkpoint: the step after restoring gave loss {loss} "
             f"with {launches} group_prox launches")
    return dict(step=step, leaves=len(saved), file_bytes=nbytes, save_s=save_s,
                restore_s=restore_s, leaves_bitwise=True, next_loss=loss,
                next_step_group_prox_launches=launches)


def phase_train_olmo(dev, cfg):
    """olmo-1b at full width (``cfg``: configs/olmo_1b.py, in the full run
    cut to TRAIN_LAYERS layers: bf16 parameters and compute, remat on)
    trained by the port's ``make_train_step`` with ProxSGD over every
    site's groups: one warm step and TRAIN_STEPS timed ones, the
    kernel-vs-XLA-route update check, and a profiled step."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.optim.optimizers import prox_sgd, tree_leaves
    from repro_torch.training.regularize import site_group_specs
    from repro_torch.training.trainer import (init_train_state,
                                              make_train_step,
                                              record_step_metrics)

    specs = site_group_specs(api.abstract_params(cfg), cfg, TRAIN_LAM)
    opt = prox_sgd(momentum=0.9, specs=specs)
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, opt, prox_specs=specs, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = make_train_step(cfg, opt, lr=TRAIN_LR, prox_specs=specs)
    lm = MarkovLM(vocab=cfg.vocab, k=8, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                lm.batch(TRAIN_BATCH, TRAIN_SEQ, seed=i).items()}
               for i in range(TRAIN_STEPS + 5)]
    param_bytes = tensor_bytes(*tree_leaves(state.params))
    torch.cuda.reset_peak_memory_stats()
    registry = MetricsRegistry()
    g0 = global_launches()
    dispatch.reset_launch_count()  # counts of the main path start here ...
    step_ms, losses, dead, penalty, gnorm = [], [], [], [], []
    for i in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
        dead.append(int(m["dead_groups"]))
        penalty.append(float(m["prox_penalty"]))
        # where the loop reads the metrics anyway, as the launcher records
        record_step_metrics(registry, m, step=i)
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_STEPS + 1
    if not all(np.isfinite(losses)):
        fail(f"train olmo: non-finite loss {losses}")
    if set(counts) != {"group_prox"} or counts["group_prox"] != len(specs) * steps:
        fail(f"train olmo: launched {counts}, expected {len(specs)} group_prox "
             f"launches a step over {steps} steps and nothing else")
    train_metrics = {name: row["values"][0]["value"]
                     for name, row in registry.snapshot().items()}
    if (train_metrics["train_steps_total"] != steps
            or train_metrics["train_step"] != steps - 1
            or train_metrics["train_loss"] != losses[-1]
            or global_launches() - g0 != counts["group_prox"]):
        fail(f"train olmo: the registry holds {train_metrics} after {steps} "
             f"steps (kernel_launches_total +{global_launches() - g0})")
    # the meshed step (a one-rank NCCL mesh) == the unsharded step, one step
    with one_rank_world():
        t0 = time.perf_counter()
        meshed = meshed_vs_unsharded(cfg, opt, specs, state,
                                     [batches[steps + 3]])
        meshed["wall_s"] = time.perf_counter() - t0
    state, prof = profile_train_step(cfg, opt, specs, state, batches[steps])
    check = check_update_routes(state, specs, batches[steps + 1], cfg, dev)
    ckpt = checkpoint_round_trip(state, step_fn, batches[steps + 2], specs)
    ms = float(np.median(step_ms[1:]))
    return dict(phase="train_olmo", arch=cfg.name, layers=cfg.n_layers,
                d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab,
                param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
                remat=cfg.remat, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                lam=TRAIN_LAM, specs=[(s.name, s.kind) for s in specs],
                init_s=init_s, first_step_ms=step_ms[0], step_ms=step_ms,
                ms_per_step=ms, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                peak_device_bytes=peak, param_bytes=param_bytes,
                group_prox_launches_per_step=counts["group_prox"] / steps,
                group_prox_ms_per_step=prof["group_prox_device_ms"],
                group_prox_share_of_step=prof["group_prox_device_ms"] / ms,
                loss=losses, grad_norm=gnorm, dead_groups=dead,
                prox_penalty=penalty, update_check=check, profile=prof,
                checkpoint=ckpt, train_metrics=train_metrics,
                meshed_step=meshed), counts, by_shape, steps


MLP_TRAIN_ARGS = ["--arch", "mlp", "--prox", "--lambda", "0.1", "--epochs", "3"]


def phase_train_mlp(dev):
    """The port's launcher on the paper's MLP: --arch mlp --prox --lambda 0.1
    --epochs 3, in process; K5 twice a step (fc1, fc2).  The trained params
    and the held-out set are returned for the compressor."""
    from repro_torch.launch import train

    dispatch.reset_launch_count()  # counts of the main path start here ...
    stats, params, test = train.train_mlp(train.parse_args(MLP_TRAIN_ARGS), dev)
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    if counts != {"group_prox": 2 * stats["steps"]}:
        fail(f"train mlp: launched {counts} over {stats['steps']} steps, "
             "expected 2 group_prox launches a step and nothing else")
    if not 0.0 <= stats["accuracy"] <= 1.0:
        fail(f"train mlp: accuracy {stats['accuracy']}")
    return (dict(phase="train_mlp", **stats,
                 group_prox_launches_per_step=counts["group_prox"] / stats["steps"]),
            counts, by_shape, stats["steps"], (params, test, stats["accuracy"]))


def run_train(dev, layers=None):
    """The training phases: K5's cases, olmo-1b at full width (cut to
    ``layers`` layers when given), the MLP.  Returns the kernel rows, the
    training runs' launch counts and the trained MLP (params, held-out set,
    accuracy)."""
    cfg = get_arch("olmo-1b")
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    rows = phase_train_kernels(dev, cfg)
    emit(dict(phase="train_kernels", tolerance_float32=PROX_TOL,
              tolerance_bf16=f"one bf16 ulp of the plain version + "
                             f"{PROX_TOL} * |a|",
              killed_rows_margin=PROX_MARGIN, rows=rows))
    torch.cuda.empty_cache()
    olmo, counts, by_shape, steps = phase_train_olmo(dev, cfg)
    emit(olmo)
    serves = {f"{cfg.name} train": (counts, by_shape, steps)}
    gc.collect()
    torch.cuda.empty_cache()
    mlp, counts, by_shape, steps, trained = phase_train_mlp(dev)
    emit(mlp)
    serves["mlp train"] = (counts, by_shape, steps)
    return rows, serves, trained


# ------------------------------------------------ distributed/ (slice 20)

# one card: an NCCL world of one rank; more ranks run on the CPU with gloo
# (tests/test_torch_distributed_*.py)
MESH_STEPS = 3  # --only distributed: meshed == unsharded over these steps
LAUNCHER_ARGS = ["--seq", str(TRAIN_SEQ), "--steps", "3"]


class one_rank_world:
    """This process as the one rank of an NCCL world (a file store under a
    temporary directory) while the block runs."""

    def __enter__(self):
        import tempfile

        from repro_torch.distributed import device_mesh

        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
        device_mesh.join(0, 1, backend="nccl", device_index=0,
                         init_method=f"file://{os.path.join(self.tmp, 'store')}")
        return self

    def __exit__(self, *exc):
        import shutil

        from repro_torch.distributed import device_mesh

        device_mesh.leave()
        shutil.rmtree(self.tmp, ignore_errors=True)


def spec_axes(specs) -> int:
    """Named axes over every spec of a tree: the gathers of one pass."""
    from repro_torch.distributed.placement import axes_of
    from repro_torch.distributed.sharding import P

    if isinstance(specs, P):
        return sum(len(axes_of(e)) for e in specs)
    if specs is None:
        return 0
    if isinstance(specs, dict):
        return sum(spec_axes(v) for v in specs.values())
    if isinstance(specs, (list, tuple)):
        return sum(spec_axes(v) for v in specs)
    import dataclasses
    return sum(spec_axes(getattr(specs, f.name))
               for f in dataclasses.fields(specs)
               if not f.metadata.get("static"))


def predicted_collectives(state, compressed: bool) -> dict:
    """The collectives one meshed step issues on a one-rank mesh: a gather
    a named axis of every leaf of the state; a float32 all-reduce a
    gradient leaf (the one batch axis) and one for the loss; compressed,
    also two a leaf across pods (row max, int32 sum), one gather a leaf of
    the new residual rows and one for the loss across pods."""
    n = len(tree_leaves_of(state.params))
    gathers = spec_axes(state.pspecs)
    if not compressed:
        return {"all_gather": gathers, "all_reduce": n + 1}
    return {"all_gather": gathers + n, "all_reduce": n + 1 + 2 * n + 1}


def tree_leaves_of(tree):
    from repro_torch.optim.optimizers import tree_leaves

    return tree_leaves(tree)


def timed(fn, *a):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal (signed zeros and NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    w = view[a.element_size()]
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    return torch.equal(a.contiguous().view(w), b.contiguous().view(w))


def meshed_vs_unsharded(cfg, opt, specs, state, batches) -> dict:
    """From one state: the unsharded step on ``state`` and the meshed step
    over a one-rank 1 x 1 mesh on a sharded copy, batch for batch.  Loss,
    grad norm and, after the last step, every parameter and optimizer leaf
    bit for bit; 7 K5 launches a step on both; the collectives per step as
    :func:`predicted_collectives` says.  Updates ``state`` in place."""
    from repro_torch.distributed import collectives, device_mesh
    from repro_torch.distributed.placement import gather_state, shard_state
    from repro_torch.training.trainer import make_train_step

    mesh = device_mesh.make_mesh((1, 1), ("data", "model"))
    sharded = shard_state(state, mesh)
    fns = {"unsharded": make_train_step(cfg, opt, lr=TRAIN_LR,
                                        prox_specs=specs),
           "meshed": make_train_step(cfg, opt, lr=TRAIN_LR, prox_specs=specs,
                                     mesh=mesh)}
    ms = {k: [] for k in fns}
    peak, launches, counts, want = {}, {k: [] for k in fns}, [], []
    for b in batches:
        m = {}
        for tag, fn in fns.items():
            torch.cuda.reset_peak_memory_stats()
            n0 = dispatch.launch_count("group_prox")
            collectives.reset_collective_counts()
            if tag == "meshed":
                want.append(predicted_collectives(sharded, False))
                (sharded, m[tag]), t = timed(fn, sharded, b)
                counts.append(collectives.collective_counts())
            else:
                (state, m[tag]), t = timed(fn, state, b)
            ms[tag].append(t)
            launches[tag].append(dispatch.launch_count("group_prox") - n0)
            peak[tag] = max(peak.get(tag, 0), torch.cuda.max_memory_allocated())
        for k in ("loss", "grad_norm", "dead_groups", "prox_penalty"):
            if not same_bits(m["meshed"][k], m["unsharded"][k]):
                fail(f"meshed step: {k} {float(m['meshed'][k])} against the "
                     f"unsharded step's {float(m['unsharded'][k])}")
    whole = _flatten(gather_state(sharded, mesh))
    plain = _flatten(state)
    bad = [k for k, v in plain.items() if not same_bits(whole[k], v)]
    if list(whole) != list(plain) or bad:
        fail(f"meshed step: leaves differing from the unsharded step {bad[:5]}")
    if counts != want:
        fail(f"meshed step: collectives {counts}, predicted {want}")
    if set(launches["meshed"]) != {len(specs)} or launches["meshed"] != launches["unsharded"]:
        fail(f"meshed step: group_prox launches {launches}, expected "
             f"{len(specs)} a step on both")
    del sharded, whole
    torch.cuda.empty_cache()
    return dict(mesh={"data": 1, "model": 1}, steps=len(batches),
                leaves_bitwise=len(plain), ms_per_step=ms,
                peak_device_bytes=peak, group_prox_launches=launches,
                collectives_per_step=counts)


def compressed_psum_check(grads, group, cpu_group, dev) -> dict:
    """``compressed_psum`` over one whole layer's leaves (layer 0 of each
    stacked leaf; residuals seeded) on the card against the same function
    on the CPU (a gloo group of the same rank), bit for bit, in the
    gradients' bf16 and in float32; at one pod g_hat + e' == v within
    float32 rounding (the float32 call).  Then the whole model's gradients
    and residuals timed, beside their byte bound."""
    from repro_torch.distributed.compress_grads import compressed_psum
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    layer = {k: v[0] for k, v in _flatten(grads["blocks"]).items()}
    gen = torch.Generator(device=dev).manual_seed(5)
    errs = tree_map(lambda g: torch.randn(g.shape, generator=gen, device=dev)
                    * 1e-4, layer)
    out = dict(layer_leaves=len(layer),
               layer_elements=sum(g.numel() for g in layer.values()))
    worst_sum = 0.0
    for tag, cast in (("bf16", lambda t: t), ("float32", lambda t: t.float())):
        g = tree_map(cast, layer)
        h_dev, e_dev = compressed_psum(g, errs, group)
        h_cpu, e_cpu = compressed_psum(tree_map(lambda t: t.cpu(), g),
                                       tree_map(lambda t: t.cpu(), errs),
                                       cpu_group)
        for name in layer:
            if not (same_bits(h_dev[name], h_cpu[name])
                    and same_bits(e_dev[name], e_cpu[name])):
                fail(f"compressed_psum ({tag}): {name} on the card differs "
                     "from the CPU's")
        if tag == "float32":
            for name, gv in g.items():
                v = gv + errs[name]
                err = (h_dev[name] + e_dev[name] - v).abs()
                bound = 2.0 ** -23 * v.abs().amax(-1, keepdim=True) + 1e-30
                worst_sum = max(worst_sum, float((err / bound).max()))
                if (err > bound).any():
                    fail(f"compressed_psum: g_hat + e' != v for {name} "
                         f"({float(err.max())})")
        del h_dev, e_dev, h_cpu, e_cpu
    out["bitwise_cpu"] = True
    out["sum_check_worst_in_f32_rounding"] = worst_sum
    # the whole model: every gradient leaf and its float32 residual row
    res = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                         device=dev), grads)
    compressed_psum(grads, res, group)  # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    compressed_psum(grads, res, group)
    ev[1].record()
    torch.cuda.synchronize()
    leaves = tree_leaves(grads)
    n = sum(g.numel() for g in leaves)
    nbytes = sum(2 * g.numel() * g.element_size() + 2 * 4 * g.numel()
                 for g in leaves)
    out.update(model_elements=n, model_ms=ev[0].elapsed_time(ev[1]),
               bound_bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    return out


def compressed_steps(cfg, opt, specs, box, batches, dev) -> dict:
    """The compressed step over a one-rank 1 x 1 x 1 mesh from
    ``box["state"]`` given the reference's default residuals (2 rows):
    finite losses, the residuals' rows 2 -> 1, 7 K5 launches and the
    predicted collectives a step; then ``compressed_psum_check`` on
    gradients of the stepped params.  Takes the state out of ``box`` so
    its whole leaves are freed once sharded."""
    import dataclasses

    from repro_torch.distributed import collectives, device_mesh
    from repro_torch.distributed.placement import gather_state, shard_state
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.training.trainer import make_train_step

    mesh = device_mesh.make_mesh((1, 1, 1), ("pod", "data", "model"))
    state = box.pop("state")
    efb = tree_map(lambda p: torch.zeros((2,) + tuple(p.shape),
                                         dtype=torch.float32, device=dev),
                   state.params)
    sharded = shard_state(dataclasses.replace(state, error_fb=efb), mesh)
    del efb, state
    gc.collect()
    torch.cuda.empty_cache()
    rows0 = {t.shape[0] for t in tree_leaves(sharded.error_fb)}
    fn = make_train_step(cfg, opt, lr=TRAIN_LR, prox_specs=specs, mesh=mesh,
                         grad_compression=True)
    torch.cuda.reset_peak_memory_stats()
    ms, losses, counts, want, launches = [], [], [], [], []
    for b in batches:
        want.append(predicted_collectives(sharded, True))
        collectives.reset_collective_counts()
        n0 = dispatch.launch_count("group_prox")
        (sharded, m), t = timed(fn, sharded, b)
        launches.append(dispatch.launch_count("group_prox") - n0)
        counts.append(collectives.collective_counts())
        ms.append(t)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    rows = {t.shape[0] for t in tree_leaves(sharded.error_fb)}
    if not all(np.isfinite(losses)) or rows0 != {2} or rows != {1}:
        fail(f"compressed step: losses {losses}, residual rows {rows0} -> {rows}")
    if counts != want or set(launches) != {len(specs)}:
        fail(f"compressed step: collectives {counts} (predicted {want}), "
             f"group_prox launches {launches}")
    whole = gather_state(sharded, mesh)
    del sharded
    params = whole.params
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = api.train_loss(params, cfg, batches[-1])
    it = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                  materialize_grads=True))
    grads = tree_map(lambda _: next(it), params)
    del loss, whole, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    import torch.distributed as tdist

    psum = compressed_psum_check(grads, mesh.group("pod"),
                                 tdist.new_group([0], backend="gloo"), dev)
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return dict(mesh={"pod": 1, "data": 1, "model": 1}, ms_per_step=ms,
                loss=losses, residual_rows=[sorted(rows0), sorted(rows)],
                peak_device_bytes=peak, group_prox_launches=launches,
                collectives_per_step=counts, compressed_psum=psum)


def ring_checks(dev) -> dict:
    """GPipe and the overlapped all-gather matmul at one rank on CUDA
    tensors (a ring of one: no peer, the schedule and the final sum still
    run): GPipe within 1e-5 of the sequential layers, the matmul within
    1e-4 of ``x @ w``."""
    from repro_torch.distributed import device_mesh
    from repro_torch.distributed.overlap import overlapped_ag_matmul
    from repro_torch.distributed.pipeline import gpipe_forward, split_stages

    gen = torch.Generator(device=dev).manual_seed(9)
    d, n_layers = 2048, 4
    w = torch.randn(n_layers, d, d, generator=gen, device=dev) / d ** 0.5
    bias = torch.randn(n_layers, d, generator=gen, device=dev) * 0.1
    x = torch.randn(4, BATCH, d, generator=gen, device=dev)

    def stage_fn(p, h):
        for i in range(p["w"].shape[0]):
            h = torch.tanh(h @ p["w"][i] + p["b"][i])
        return h

    pipe = device_mesh.make_mesh((1,), ("pipe",))
    got = gpipe_forward(split_stages({"w": w, "b": bias}, 1), x, stage_fn,
                        mesh=pipe)
    want = torch.stack([stage_fn({"w": w, "b": bias}, xm) for xm in x])
    gp_err = float((got - want).abs().max())
    model = device_mesh.make_mesh((1,), ("model",))
    xm = torch.randn(BATCH, d, generator=gen, device=dev)
    wm = torch.randn(d, 8192, generator=gen, device=dev)
    ov_err = float((overlapped_ag_matmul(xm, wm, mesh=model) - xm @ wm).abs().max())
    if gp_err > 1e-5 or ov_err > 1e-4:
        fail(f"gpipe max err {gp_err} (1e-5), overlapped matmul {ov_err} (1e-4)")
    return dict(gpipe_max_abs_err=gp_err, gpipe_shape=list(x.shape),
                overlap_max_abs_err=ov_err, overlap_shape=[BATCH, d, 8192])


def distributed_launchers() -> dict:
    """The train launcher at full width on one rank: ``--mesh 1x1x1
    --grad-compression`` and ``--mesh 1x1 --elastic-demo`` (which fires
    nothing at one rank, as in the reference)."""
    import contextlib
    import io

    from repro_torch.launch import train

    out = {}
    for tag, flags in (("compressed", ["--mesh", "1x1x1", "--grad-compression"]),
                       ("elastic", ["--mesh", "1x1", "--elastic-demo"])):
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            stats = train.main(flags + LAUNCHER_ARGS)
        text = log.getvalue()
        if not np.isfinite(stats["loss"]) or "[elastic]" in text:
            fail(f"train launcher {flags}: {stats} / {text[-400:]}")
        out[tag] = dict(flags=flags + LAUNCHER_ARGS, wall_s=time.perf_counter() - t0,
                        loss=stats["loss"], mesh=stats["mesh"],
                        steps=stats["steps"], last_line=text.strip().splitlines()[-1])
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_distributed(dev) -> dict:
    """``--only distributed``: olmo-1b at full width (bf16, remat, ProxSGD
    over every site, batch 8 x 512) on a one-rank NCCL world: the meshed
    step against the unsharded step over MESH_STEPS steps from one state,
    then the compressed step at 1 x 1 x 1 and ``compressed_psum`` on the
    card against the CPU; GPipe and the overlapped matmul at one rank; the
    launcher's mesh flags."""
    from repro_torch.optim.optimizers import prox_sgd
    from repro_torch.training.regularize import site_group_specs
    from repro_torch.training.trainer import init_train_state

    cfg = get_arch("olmo-1b")
    specs = site_group_specs(api.abstract_params(cfg), cfg, TRAIN_LAM)
    opt = prox_sgd(momentum=0.9, specs=specs)
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, opt, prox_specs=specs, device=dev)
    init_s = time.perf_counter() - t0
    lm = MarkovLM(vocab=cfg.vocab, k=8, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                lm.batch(TRAIN_BATCH, TRAIN_SEQ, seed=i).items()}
               for i in range(MESH_STEPS + 2)]
    box = {"state": state}
    del state
    with one_rank_world():
        meshed = meshed_vs_unsharded(cfg, opt, specs, box["state"],
                                     batches[:MESH_STEPS])
        compressed = compressed_steps(cfg, opt, specs, box,
                                      batches[MESH_STEPS:], dev)
        rings = ring_checks(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(phase="distributed", arch=cfg.name, layers=cfg.n_layers,
                d_model=cfg.d_model, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                backend="nccl", world=1, init_s=init_s, meshed=meshed,
                compressed=compressed, rings=rings,
                launchers=distributed_launchers())


# ------------------------------------------------- the serving mesh

# ServingEngine(mesh=) on a one-rank NCCL world: the 1 x 1 mesh runs every
# collective of the sharded step through NCCL (each gather one copy) and
# must give the unsharded engine's tokens and logits bit for bit; 2- and
# 4-rank meshes run on the CPU (tests/test_torch_sharded_serving.py)
MESH_PROMPTS = 6
MESH_MAX_NEW = 16
MOE_MANUAL_MAX_NEW = 4


def first_layers(art, n: int):
    """``art`` cut to its first ``n`` layers: those layers' records and
    packed sites, the stacked parameters' first ``n`` rows (views), no
    plans (each serve packs its own)."""
    import re

    def layer(name):
        return int(re.search(r"\.l(\d+)(?:\.|$)", name).group(1))

    records = {k: v for k, v in art.records.items() if layer(k) < n}
    params = dict(art.params)
    params["blocks"] = {k: tree_cut(v, n) for k, v in art.params["blocks"].items()}
    return replace(art, config=replace(art.config, n_layers=n),
                   records=records, params=params, plans={},
                   packed={k: v for k, v in art.packed.items() if k in records})


def tree_cut(tree, n):
    if isinstance(tree, dict):
        return {k: tree_cut(v, n) for k, v in tree.items()}
    return tree[:n]


def mesh_step_collectives(route: str, n_layers: int) -> dict:
    """The collectives of one olmo-1b decode step over a 1 x 1 mesh (the
    slots do not split; every weight's spec names both axes): the
    embedding gathers its "data" axis and all-reduces its vocabulary split,
    the tied head gathers "data" and its vocabulary columns; the plan route
    gathers the K and V pools for its kernels, the per-region route's
    attention all-reduces its partial scores and gathers its output a
    layer (the projections run on whole compressed sites)."""
    if route == "plan":
        return {"all_gather": 1 + 2 + 2, "all_reduce": 1}
    return {"all_gather": 1 + 2 + n_layers, "all_reduce": 1 + n_layers}


def mesh_copy_bytes(eng) -> int:
    """The bytes one meshed olmo-1b decode step copies through its gathers
    at world size 1: the embedding table twice (the lookup, the tied head),
    and the K and V pools (plan route) or each layer's attention output
    (per-region route)."""
    cfg = eng.cfg
    emb = eng.params["embed"].local
    out = 2 * emb.numel() * emb.element_size()
    if eng.n_layer_plans:
        return out + sum(eng.state[k].numel() * eng.state[k].element_size()
                         for k in ("k", "v"))
    return out + cfg.n_layers * BATCH * cfg.n_heads * cfg.hd * 4


def engine_logits(art, dev, mesh) -> torch.Tensor:
    """Two decode steps' logits [2, B, V] of a fresh engine on ``art`` (over
    ``mesh`` when given) after an 8-token prompt in every slot: seeded
    tokens at positions 8 and 9, each row written into its slot's own
    block (rows of a fresh table all map the null block, and a scatter of
    duplicate indices leaves any one of them on the card)."""
    eng = ServingEngine(artifact=art, n_slots=BATCH, max_len=MAX_LEN,
                        kv_block=16, device=dev, mesh=mesh, metrics=False)
    for p in prompts_for(art.config, BATCH):
        eng.submit(p)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, art.config.vocab, (2, BATCH, 1)))
    out = [eng.decode_logits(toks[t], torch.full((BATCH,), 8 + t)).float()
           for t in range(2)]
    del eng
    return torch.stack(out)


def step_collectives(eng, prompts) -> dict:
    """The collectives of one decode step of ``eng`` (idle after its serve):
    the prompts admitted again, one step taken, the next one counted."""
    from repro_torch.distributed import collectives

    for p in prompts:
        eng.submit(p, max_new=4)
    eng.step()
    collectives.reset_collective_counts()
    eng.step()
    torch.cuda.synchronize()
    return collectives.collective_counts()


def mesh_pair(art, dev, mesh, route, *, max_new=MESH_MAX_NEW, predict=True):
    """``art`` served unsharded and over ``mesh`` (6 prompts on 8 slots):
    tokens and two steps' logits bit for bit, the same launches a step,
    the meshed step's collectives as :func:`mesh_step_collectives` says
    (``predict``), ms a step and peak device bytes of both."""
    from repro_torch.distributed import collectives

    cfg = art.config
    prompts = prompts_for(cfg, MESH_PROMPTS)
    out, toks = {}, {}
    for tag, m in (("unsharded", None), ("meshed", mesh)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        collectives.reset_collective_counts()
        eng, res, step_s = serve(art, dev, use_kernel=True, n_slots=BATCH,
                                 prompts=prompts, max_new=max_new, mesh=m)
        torch.cuda.synchronize()
        served = collectives.collective_counts()
        peak = torch.cuda.max_memory_allocated()
        for r in res:
            if r.error or not r.finished or len(r.tokens) != r.prompt_len + max_new:
                fail(f"mesh {route} {tag}: a request did not finish: {r.error}")
        toks[tag] = [r.tokens for r in res]
        stats = eng.plan_stats()
        out[tag] = dict(ms_per_step=float(np.median(step_s[1:] or step_s)) * 1e3,
                        steps=len(step_s), peak_device_bytes=peak,
                        launches_per_step=eng.kernel_launches_per_step,
                        n_layer_plans=stats["n_layer_plans"],
                        fallbacks=stats["fallbacks"],
                        serve_collectives=served)
        if m is not None:
            out[tag].update(mesh=stats["mesh"],
                            step_collectives=step_collectives(eng, prompts),
                            copy_bytes_per_step=mesh_copy_bytes(eng))
        del eng, res
    lg = {tag: engine_logits(art, dev, m)
          for tag, m in (("unsharded", None), ("meshed", mesh))}
    gc.collect()
    torch.cuda.empty_cache()
    want = mesh_step_collectives(route, cfg.n_layers) if predict else None
    m, u = out["meshed"], out["unsharded"]
    if toks["meshed"] != toks["unsharded"]:
        fail(f"mesh {route}: tokens differ from the unsharded engine's")
    if not same_bits(lg["meshed"], lg["unsharded"]):
        fail(f"mesh {route}: logits differ from the unsharded engine's by "
             f"{float((lg['meshed'] - lg['unsharded']).abs().max())}")
    if (m["launches_per_step"] != u["launches_per_step"]
            or m["fallbacks"] != u["fallbacks"] or m["mesh"]["fallbacks"]
            and cfg.moe is None):
        fail(f"mesh {route}: launches/fallbacks {m} against {u}")
    if predict and m["step_collectives"] != want:
        fail(f"mesh {route}: collectives a step {m['step_collectives']}, "
             f"predicted {want}")
    return dict(route=route, arch=cfg.name, layers=cfg.n_layers,
                dtype=cfg.compute_dtype, tokens_bitwise=True,
                logits_bitwise=True, logits_shape=list(lg["meshed"].shape),
                predicted_collectives=want,
                sample_tokens=toks["meshed"][0][-max_new:], **out)


def phase_mesh_serve(dev, art32) -> dict:
    """The serving mesh's check on ``art32`` (olmo-1b's float32 fixture at
    full width, cut in depth): ``ServingEngine(mesh=make_mesh((1, 1),
    ("data", "model")))`` against the unsharded engine, on the float32
    plan route and on the bf16 per-region route of a cast of its
    parameters (:func:`mesh_pair`)."""
    from repro_torch.distributed.device_mesh import make_mesh

    t0 = time.perf_counter()
    base = replace(art32.config, param_dtype=get_arch("olmo-1b").param_dtype,
                   compute_dtype=get_arch("olmo-1b").compute_dtype)
    art16 = replace(art32, config=base,
                    params=cast(art32.params, torch.bfloat16))
    CompressedExecutor(art32, device=dev).step_plan(art32.config)
    with one_rank_world():
        mesh = make_mesh((1, 1), ("data", "model"))
        routes = [mesh_pair(art32, dev, mesh, "plan"),
                  mesh_pair(art16, dev, mesh, "per-region")]
    del art16
    drop_per_region_copies(art32)
    return dict(phase="mesh_serve", arch=art32.config.name,
                layers=art32.config.n_layers, mesh={"data": 1, "model": 1},
                backend="nccl", world=1, n_slots=BATCH,
                requests=MESH_PROMPTS, max_new=MESH_MAX_NEW, routes=routes,
                seconds=time.perf_counter() - t0)


def phase_mesh_distributed(dev) -> dict:
    """``--only distributed``'s serving checks: the full run's mesh_serve
    check (olmo-1b cut to MESH_SERVE_LAYERS), olmo-1b uncut on both routes
    under the 1 x 1 mesh, and mixtral-8x22b cut to MIXTRAL_LAYERS in
    float32 with ``moe_manual`` (the step plan refused by name: the experts
    on their dense weights through ``moe_ffn_manual`` under the mesh,
    ``moe_ffn`` without it) — each against the unsharded engine, tokens and
    logits bit for bit."""
    from repro_torch.distributed.device_mesh import make_mesh

    t0 = time.perf_counter()
    base = get_arch("olmo-1b")
    cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
    art32 = seeded_artifact(cfg32, seed=2, device=dev)
    cut = phase_mesh_serve(dev, first_layers(art32, MESH_SERVE_LAYERS))
    emit(cut)
    uncut = phase_mesh_serve(dev, art32)
    emit(dict(uncut, phase="mesh_serve_uncut"))
    del art32
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = replace(get_arch("mixtral-8x22b"), n_layers=MIXTRAL_LAYERS,
                   param_dtype="float32", compute_dtype="float32",
                   moe_manual=True)
    t1 = time.perf_counter()
    mart = seeded_artifact(mcfg, seed=2, device=dev, host_effective=False)
    fixture_s = time.perf_counter() - t1
    with one_rank_world():
        mesh = make_mesh((1, 1), ("data", "model"))
        manual = mesh_pair(mart, dev, mesh, "per-region",
                           max_new=MOE_MANUAL_MAX_NEW, predict=False)
    if manual["meshed"]["fallbacks"] != {"step": "moe_manual"}:
        fail(f"moe_manual: plan fallbacks {manual['meshed']['fallbacks']}")
    del mart
    gc.collect()
    torch.cuda.empty_cache()
    return dict(phase="mesh_moe_manual", arch=mcfg.name, layers=mcfg.n_layers,
                fixture_s=fixture_s, moe_manual=manual,
                seconds=time.perf_counter() - t0)


# ------------------------------------ the compressor (Algorithm 1), PR 23

# the compress launcher's default config (src/repro/launch/compress.py:61-62)
COMPRESS_DEFAULT = dict(algorithm="fp", weight_sharing=True,
                        max_share_rel_err=0.06)
# the train launcher's handoff config (src/repro/launch/train.py:12): dead
# input groups kept in place (skipped and shrunk slice jobs), no sharing, so
# fc1's decomposition takes all 784 inputs, as mlp_forward_compressed needs
COMPRESS_HANDOFF = dict(algorithm="fp", prune_tol=-1e-6, weight_sharing=False)
COMPRESS_WORKERS = (1, 4)
# the reference compress launcher's --quickstart olmo-1b
# (src/repro/launch/compress.py:54-55)
QUICKSTART = dict(vocab=64, n_layers=2, d_model=32, d_ff=48, n_heads=2,
                  n_kv_heads=2, head_dim=16)
MLP_SERVE = "mlp compressed"  # the serve name of fc1's K1 forward


def artifact_diff(a, b) -> list[str]:
    """Where two artifacts differ: records (kept columns, sharing, effective
    maps, every factor's streams), packed buffers, effective params and the
    report, compared bitwise.  Empty when they agree."""
    bad = []
    if list(a.records) != list(b.records):
        return ["unit list"]
    for name, ra in a.records.items():
        rb = b.records[name]
        same = (np.array_equal(ra.kept_columns, rb.kept_columns)
                and ra.effective.tobytes() == rb.effective.tobytes()
                and (ra.shared is None) == (rb.shared is None)
                and (ra.shared is None
                     or (ra.shared.labels.tobytes() == rb.shared.labels.tobytes()
                         and ra.shared.centroids.tobytes()
                         == rb.shared.centroids.tobytes()))
                and ra.decomposition.meta == rb.decomposition.meta
                and ra.decomposition.to_dense().tobytes()
                == rb.decomposition.to_dense().tobytes())
        pa, pb = a.packed[name], b.packed[name]
        same = same and all(np.array_equal(getattr(pa, f), getattr(pb, f))
                            for f in ("idx", "exp", "sign"))
        same = same and pa.chain_lengths == pb.chain_lengths
        if not same:
            bad.append(name)
    # by name: a loaded artifact's params come back in sorted key order
    pa, pb = _flatten(a.params), _flatten(b.params)
    if sorted(pa) != sorted(pb) or not all(torch.equal(pa[k], pb[k]) for k in pa):
        bad.append("params")
    if a.report.table() != b.report.table():
        bad.append("report")
    return bad


def compress_runs(params, cfg, compression, label):
    """``api.compress_model`` once a worker count of :data:`COMPRESS_WORKERS`
    (the pool is a forkserver: this process has touched CUDA); the runs must
    agree bit for bit.  Returns the first run's artifact and a summary: wall
    s, jobs, skipped and shrunk jobs a run, adds baseline -> lcc a unit and
    in total."""
    from repro_torch.core.compress import CompressionConfig

    runs = []
    for n_workers in COMPRESS_WORKERS:
        t0 = time.perf_counter()
        art = api.compress_model(params, cfg, CompressionConfig(**compression),
                                 n_workers=n_workers)
        runs.append((n_workers, art, time.perf_counter() - t0))
    bad = artifact_diff(runs[0][1], runs[1][1])
    if bad:
        fail(f"compress {label}: {COMPRESS_WORKERS} workers disagree at {bad}")
    art, rep = runs[0][1], runs[0][1].report
    units = {l.name: dict(baseline_adds=l.baseline_adds,
                          lcc_adds=l.stage_adds["lcc"], ratio=l.ratio("lcc"),
                          kept=l.extra["kept_cols"], clusters=l.extra["clusters"],
                          dead_groups=l.extra["dead_groups"],
                          achieved_snr_db=l.extra["achieved_snr_db"])
             for l in rep.layers}
    stats = {nw: {k: a.pipeline_stats[k] for k in (
                 "jobs", "skipped_jobs", "shrunk_jobs", "dead_groups",
                 "cache_hits", "cache_misses")} | {"wall_s": wall}
             for nw, a, wall in runs}
    return art, dict(label=label, config=compression, runs=stats,
                     bitwise_equal_across_workers=True, units=units,
                     baseline_adds=rep.total_baseline(),
                     lcc_adds=rep.total_stage("lcc"), ratio=rep.ratio("lcc"))


def save_and_load(art, dev):
    """``art`` saved to a temp directory and loaded back with ``params`` on
    ``dev`` (the directory is removed; the map lives on in the arrays).
    Returns ``(loaded, save_s, load_s, file bytes)``."""
    import tempfile

    from repro_torch.core.artifact import CompressedModel

    with tempfile.TemporaryDirectory(prefix="chip_smoke_art_") as d:
        t0 = time.perf_counter()
        art.save(d)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(d).rglob("*.msgpack"))
        t0 = time.perf_counter()
        back = CompressedModel.load(d, device=dev)
        torch.cuda.synchronize()
        return back, save_s, time.perf_counter() - t0, nbytes


def mlp_round_trip(art, x, want, dev) -> dict:
    """The compressed MLP saved, loaded and served again: fc1 through one
    K1 launch, logits bit for bit the in-memory forward's (``want``)."""
    from repro_torch.models.mlp import mlp_forward_compressed

    back, save_s, load_s, nbytes = save_and_load(art, dev)
    dispatch.reset_launch_count()  # counts of the loaded forward start here ...
    with torch.no_grad():
        got = mlp_forward_compressed(back.params, back.packed["fc1"], x)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()  # ... and are read here
    if counts != {"lcc_chain_matmul": 1}:
        fail(f"compress mlp round trip: the forward launched {counts}")
    if not torch.equal(got, want):
        fail("compress mlp round trip: the loaded artifact's logits differ "
             "from the in-memory forward's")
    return dict(file_bytes=nbytes, save_s=save_s, load_s=load_s,
                launches=counts, logits_bitwise=True)


def launcher_resume(want, dev) -> dict:
    """``python -m repro_torch.launch.compress --arch olmo-1b --quickstart
    --workers 4`` in a session of its own, SIGKILLed with its worker pool
    once four slice results are cached, then run again with ``--resume``:
    the resumed artifact must be bit for bit ``want`` (the same weights and
    config compressed in this process) and take at least four cache hits."""
    import signal
    import tempfile

    from repro_torch.core.artifact import CompressedModel

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compress_") as out:
        cmd = [sys.executable, "-m", "repro_torch.launch.compress", "--arch",
               "olmo-1b", "--quickstart", "--workers", "4", "--seed", "0",
               "--quiet", "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, cwd=root,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, start_new_session=True)
        cache = Path(out) / "cache"
        cached = 0
        try:
            while proc.poll() is None and time.perf_counter() - t0 < 300:
                cached = len(list(cache.glob("*.msgpack"))) if cache.exists() else 0
                if cached >= 4:
                    break
                time.sleep(0.01)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its pool
            killed = proc.wait() == -signal.SIGKILL
        kill_s = time.perf_counter() - t0
        if not killed or (Path(out) / "artifact").exists():
            fail(f"compress launcher: not killed mid-run (rc {proc.returncode}, "
                 f"{cached} entries): {proc.stderr.read().decode()[-2000:]}")
        t0 = time.perf_counter()
        r = subprocess.run(cmd + ["--resume"], env=env, cwd=root, timeout=300,
                           capture_output=True, text=True)
        resume_s = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"compress launcher --resume failed: {r.stderr[-2000:]}")
        stats = json.loads((Path(out) / "stats.json").read_text())
        resumed = CompressedModel.load(str(Path(out) / "artifact"), device=dev)
    bad = artifact_diff(resumed, want)
    if bad or stats["cache_hits"] < 4:
        fail(f"compress launcher: the resumed artifact differs at {bad} from "
             f"an uninterrupted compression, cache hits {stats['cache_hits']}")
    return dict(workers=4, cached_when_killed=cached, kill_s=kill_s,
                resume_s=resume_s, cache_hits=stats["cache_hits"],
                cache_misses=stats["cache_misses"], jobs=stats["jobs"],
                bitwise_equal_uninterrupted=True)


def phase_compress_mlp(dev, trained, timer, sm):
    """The paper's MLP (784-300-10) as trained on the card, compressed at
    full width under the compress launcher's default config and under the
    train launcher's handoff config (each at 1 and 4 workers, bit for bit
    the same); fc1 of the handoff artifact served through K1 on the held-out
    set: one launch a forward, the kernel's output bit for bit its plain
    version in the kernel's order, logits within STEP_TOL of the
    dense-effective forward and of the plain route on the CPU.  Returns the
    phase's line, K1's row at fc1's shape and the forward's counts."""
    from repro_torch.models.mlp import (MLPConfig, mlp_forward,
                                        mlp_forward_compressed)

    params, (xte, yte), acc_dense = trained
    cfg = MLPConfig(hidden=int(params["fc1"]["w"].shape[0]))
    art_d, default = compress_runs(params, cfg, COMPRESS_DEFAULT, "mlp default")
    art, handoff = compress_runs(params, cfg, COMPRESS_HANDOFF, "mlp handoff")
    pk = art.packed["fc1"]
    if pk.in_dim != cfg.in_dim or handoff["runs"][1]["skipped_jobs"] <= 0:
        fail(f"compress mlp: fc1 takes {pk.in_dim} inputs, "
             f"{handoff['runs'][1]['skipped_jobs']} skipped jobs")
    x = xte.to(dev, torch.float32)
    torch.cuda.synchronize()
    dispatch.reset_launch_count()  # counts of the compressed forward start here ...
    with torch.no_grad():
        logits = mlp_forward_compressed(art.params, pk, x)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    if counts != {"lcc_chain_matmul": 1}:
        fail(f"compress mlp: the forward launched {counts}, expected one K1")
    with torch.no_grad():
        ds = pk.on(dev)
        xt = x.T.contiguous()
        y = lcc_chain_matmul(ds.idx, ds.exp, ds.sign, xt, ds.slice_c0,
                             ds.slice_w, ds.chain_len)
        torch.cuda.synchronize()
        if not torch.equal(y[None], ordered_plain(ds, xt, sm)):
            fail("compress mlp: K1 on fc1 differs from its plain version "
                 "summed in the kernel's order")
        plain = mlp_forward(art.params, x)
        cpu = mlp_forward_compressed(to_device(art.params, "cpu"), pk, x.cpu())
    round_trip = mlp_round_trip(art, x, logits, dev)
    err_dense = check_close("mlp compressed vs dense-effective", logits, plain,
                            STEP_TOL)
    err_cpu = check_close("mlp compressed vs the CPU plain route", logits.cpu(),
                          cpu, STEP_TOL)

    def acc(lg):
        return float((torch.argmax(lg, -1).cpu() == yte.cpu()).float().mean())

    row = kernel_case_chain(f"mlp fc1 E={pk.idx.shape[0]} N={pk.out_dim} "
                            f"B={x.shape[0]}", pk, np.random.default_rng(60),
                            dev, timer, sm, batch=x.shape[0])
    row["serve"] = MLP_SERVE
    recovered, rcounts = recover_mlp(art, x, yte, dev, sm)
    line = dict(phase="compress_mlp", shape=[cfg.in_dim, cfg.hidden, cfg.classes],
                default=default, handoff=handoff,
                fc1_packed=dict(E=pk.idx.shape[0], P=pk.idx.shape[1],
                                N_pad=pk.idx.shape[2], S=pk.idx.shape[3],
                                live_slices=int(sum(1 for v in
                                                    ds.chain_len.tolist() if v))),
                held_out=int(x.shape[0]), launches=counts,
                round_trip=round_trip,
                logits_vs_dense_effective=err_dense, logits_vs_cpu_plain=err_cpu,
                tol=STEP_TOL, k1_bit_for_bit_in_kernel_order=True,
                accuracy=dict(dense=acc_dense,
                              default_effective=acc(mlp_forward(art_d.params, x)),
                              handoff_effective=acc(plain), compressed_k1=acc(logits),
                              recovered=recovered["accuracy"]["recovered"]),
                recover=recovered)
    # the compressed and the recovered forward: one K1 launch each, at the
    # same dimensions (the residual is a dense slice beside the chains)
    return line, row, merge_serve((counts, by_shape, 1), rcounts)


RECOVER_STEPS = 60  # the train launcher's --recover in its docstring's run
RECOVER_LR = 2e-3  # the train launcher's --recover-lr default
RESIDUAL_FRAC = 0.15  # and its --residual-frac


def recover_mlp(art, x, yte, dev, sm):
    """Recovery fine-tuning on the handoff artifact, as the train launcher
    runs it: 60 adam steps of the dense residual over the training set's
    batches (128, seeded 1000 + epoch), written back at 15 % of each unit's
    LCC adds.  Then fc1 through K1 on the held-out set: one launch a
    forward, K1 bit for bit its plain version in the kernel's order on the
    new packed object's fresh upload, logits within STEP_TOL of the
    recovered dense-effective forward; the recovered artifact saved, loaded
    and served the same.  Returns the summary and the forward's counts."""
    from repro_torch.data.mnist_like import train_test
    from repro_torch.data.synthetic import batches
    from repro_torch.models.mlp import (mlp_accuracy, mlp_forward,
                                        mlp_forward_compressed, mlp_loss)
    from repro_torch.training.recover import recover_artifact

    from repro_torch.launch import train

    args = train.parse_args(MLP_TRAIN_ARGS)  # the data the MLP was trained on
    (xs, ys), _ = train_test(args.train_n, args.test_n, seed=args.seed)

    def rec_batches():
        n, ep = 0, 0
        while n < RECOVER_STEPS:
            for xb, yb in batches(xs, ys, 128, seed=1000 + ep):
                if n >= RECOVER_STEPS:
                    return
                yield torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)
                n += 1
            ep += 1

    with torch.no_grad():
        acc_c = float(mlp_accuracy(art.params, x, yte))
    old = art.packed["fc1"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = recover_artifact(art, lambda p, b: mlp_loss(p, b[0], b[1]),
                           rec_batches(), lr=RECOVER_LR,
                           residual_frac=RESIDUAL_FRAC)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pk = art.packed["fc1"]
    if pk is old or pk._dev:
        fail("recover mlp: write_back kept the old packed fc1 or its device copy")
    dispatch.reset_launch_count()  # counts of the recovered forward start here ...
    with torch.no_grad():
        logits = mlp_forward_compressed(art.params, pk, x)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    if counts != {"lcc_chain_matmul": 1}:
        fail(f"recover mlp: the recovered forward launched {counts}")
    with torch.no_grad():
        ds = pk.on(dev)
        xt = x.T.contiguous()
        y = lcc_chain_matmul(ds.idx, ds.exp, ds.sign, xt, ds.slice_c0,
                             ds.slice_w, ds.chain_len)
        torch.cuda.synchronize()
        if not torch.equal(y[None], ordered_plain(ds, xt, sm)):
            fail("recover mlp: K1 on fc1 differs from its plain version "
                 "summed in the kernel's order")
        dense = mlp_forward(art.params, x)
        acc_r = float(mlp_accuracy(art.params, x, yte))
    err = check_close("recovered mlp vs its dense-effective forward", logits,
                      dense, STEP_TOL)
    round_trip = mlp_round_trip(art, x, logits, dev)
    units = res["units"]
    return dict(steps=len(res["losses"]), lr=RECOVER_LR,
                residual_frac=RESIDUAL_FRAC, wall_s=wall,
                loss_first=res["losses"][0], loss_last=res["losses"][-1],
                accuracy=dict(compressed=acc_c, recovered=acc_r,
                              recovered_k1=float((torch.argmax(logits, -1)
                                                  == yte).float().mean())),
                units=units,
                lcc_adds=sum(u.get("lcc_adds", 0) for u in units.values()),
                residual_adds=sum(u["recover_adds"] for u in units.values()),
                fc1_dense_slices=len(pk.dense), launches=counts,
                k1_bit_for_bit_in_kernel_order=True,
                logits_vs_dense_effective=err, tol=STEP_TOL,
                round_trip=round_trip), (counts, by_shape, 1)


# the reference launcher's docstring run, end to end (--compress-out added)
HANDOFF_ARGS = ["--arch", "mlp", "--prox", "--lambda", "0.1", "--epochs", "12",
                "--recover", "60", "--compress-config", "algorithm=fp",
                "prune_tol=-1e-6", "weight_sharing=false"]


def phase_train_handoff(dev):
    """``python -m repro_torch.launch.train`` with :data:`HANDOFF_ARGS` and
    ``--compress-out`` to a temp directory, in process, its own output kept
    apart: train -> compress -> recover -> fused serve.  Its
    ``train_stats.json`` goes on a line of its own, beside the reference's
    ``BENCH_train.json`` claim (a CPU record of the JAX package, not a
    target)."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_handoff_") as out:
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            train.main([*HANDOFF_ARGS, "--compress-out", out])
        wall = time.perf_counter() - t0
        files = sorted(p.name for p in Path(out).iterdir())
        stats = json.loads((Path(out) / "train_stats.json").read_text())
    if files != ["artifact", "cache", "run", "train_stats.json"]:
        fail(f"train handoff: wrote {files}")
    acc = stats["accuracy"]
    if set(acc) != {"dense", "compressed", "recovered", "fused"} or \
            stats["recover"]["steps"] != 60:
        fail(f"train handoff: stats {sorted(acc)}, recover "
             f"{stats.get('recover', {}).get('steps')}")
    claim = None
    bench = Path(__file__).resolve().parent / "BENCH_train.json"
    if bench.exists():
        b = json.loads(bench.read_text())
        p0 = b["points"][0]
        claim = dict(source="BENCH_train.json (the JAX package on a CPU)",
                     task=b["task"], budget_frac=p0["budget_frac"],
                     regularized_recovery=p0["regularized_recovery"])
    return dict(phase="train_handoff", argv=HANDOFF_ARGS, wall_s=wall,
                train_stats=stats, reference_claim=claim)


def quickstart_rows(cfg, art, plan, dev, timer, sm, route, *,
                    serve_name=None, batch=BATCH, smax=MAX_LEN):
    """Every kernel at the dimensions the quickstart serve on ``route``
    launches it at (or the serve ``serve_name`` of ``batch`` slots over a
    ``smax``-position view), each distinct launch shape once: per-region,
    K1/K2 on every layer's regions and K3 where a region prepares; plan,
    K6's four stages in their modes, K7's norm and attention."""
    rng = np.random.default_rng(70)
    serve_name = serve_name or f"quickstart {cfg.name} {route}"
    rows, seen = [], set()
    if route == "per-region":
        for li in range(cfg.n_layers):
            for names in site_groups(cfg, li):
                members = [art.packed[n] for n in names]
                k = site_weight(art.params, names[0]).shape[0]
                if len(names) == 1:
                    key = ("lcc_chain_matmul",
                           (*members[0].idx.shape, members[0].in_dim, BATCH))
                    if key not in seen:
                        rows.append(kernel_case_chain(
                            f"quickstart {names[0]}", members[0], rng, dev,
                            timer, sm))
                else:
                    pg = ops.pack_group(members)
                    key = ("lcc_group_matmul",
                           (*pg.idx.shape, sum(m.in_dim for m in members), BATCH))
                    if key not in seen:
                        rows.append(kernel_case_group(
                            "quickstart " + "+".join(names), members, rng,
                            dev, timer, sm))
                seen.add(key)
                prep = site_prep([art.records[n] for n in names])
                if prep.identity and len(names) == 1:
                    continue
                key = ("region_prep", prep.shape_key(k, BATCH, 2))
                if key not in seen:
                    seen.add(key)
                    rows.append(kernel_case_prep(
                        "quickstart " + "+".join(names), prep, k, BATCH,
                        torch.bfloat16, False, dev, timer))
    else:
        tag = "quickstart" if batch == BATCH else serve_name
        for name in ("qkv", "o", "gu", "dn"):
            rows.append(kernel_case_stage(
                f"{tag} {name}", plan.stages[name], rng, dev, timer,
                batch=batch, w=stage_weights(art, name, 0, dev),
                mode=serve_mode(cfg, name)))
        rows.append(kernel_case_norm(cfg, dev, timer, label=f"{tag} norm",
                                     batch=batch))
        rows.append(kernel_case_attention(
            f"{tag} attention", cfg, smax, cfg.attn_window,
            serve_positions(rng, batch), dev, timer))
    for row in rows:
        row["serve"] = serve_name
    return rows


def live_roofline_line(eng, art, route) -> dict:
    """The live roofline of a serve of a really compressed artifact: the
    artifact's shift-add budget (its cost report) times the decode tok/s
    the engine's profiler measured, launches a step beside it."""
    live = live_roofline(eng)
    if live is None:
        fail(f"live roofline ({route}): none for an artifact with a report")
    tok_s = live["profiler"]["tok_s"]
    if (live["total_lcc_adds"] != art.report.total_stage("lcc")
            or not (tok_s is not None and np.isfinite(tok_s) and tok_s > 0)):
        fail(f"live roofline ({route}): lcc adds {live['total_lcc_adds']} "
             f"against the report's {art.report.total_stage('lcc')}, tok/s "
             f"{tok_s}")
    return dict(phase="live_roofline", serve=f"quickstart {art.config.name}",
                route=route, dtype=art.config.compute_dtype,
                **{k: live[k] for k in (
                    "total_baseline_adds", "total_lcc_adds",
                    "decode_tok_s_n8", "kernel_launches", "n_layer_plans",
                    "achieved_adds_per_s")},
                tok_s=tok_s, profiler=live["profiler"],
                sites=len(live["sites"]))


def phase_compress_olmo(dev, timer, sm):
    """The reference launcher's --quickstart olmo-1b, compressed by the port
    (default config; bf16 and float32 parameters, the same seed) and served
    through ``ServingEngine(artifact=...)``: bf16 on the per-region route
    (K1, K2, K3), float32 on the whole-step plan (K6, K7).  Greedy tokens
    equal the dense-effective forward's, launches a step as predicted."""
    base = reduced_config(get_arch("olmo-1b"), **QUICKSTART)
    lines, rows, serves = [], [], {}
    for dtype, route in (("bfloat16", "per-region"), ("float32", "plan")):
        cfg = replace(base, param_dtype=dtype, compute_dtype=dtype)
        params = api.init_params(0, cfg, device=dev)
        art, summary = compress_runs(params, cfg, COMPRESS_DEFAULT,
                                     f"quickstart {dtype}")
        plan = None
        if route == "plan":
            plan = CompressedExecutor(art, device=dev).step_plan(cfg)
            predicted = 7 * cfg.n_layers
            expected = set(PLAN)
        else:
            predicted = (region_launches_per_step(cfg)
                         + region_preps_per_step(cfg, art.records))
            expected = set(PER_REGION)
        rows += quickstart_rows(cfg, art, plan, dev, timer, sm, route)
        prompts = prompts_for(cfg, 6)
        dispatch.reset_launch_count()  # counts of the serve start here ...
        eng, res, step_s = serve(art, dev, use_kernel=True, n_slots=BATCH,
                                 prompts=prompts, max_new=16)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()  # ... and are read here
        by_shape = dispatch.launch_counts_by_shape()
        emit(live_roofline_line(eng, art, route))
        _, res_d, _ = serve(art, dev, use_kernel=False, n_slots=BATCH,
                            prompts=prompts, max_new=16)
        for r in res + res_d:
            if r.error or not r.finished or len(r.tokens) != r.prompt_len + 16:
                fail(f"quickstart {route}: a request did not finish: {r.error}")
        if [r.tokens for r in res] != [r.tokens for r in res_d]:
            fail(f"quickstart {route}: greedy tokens differ from the "
                 "dense-effective forward's")
        ex = eng.executor
        if ex.routed != ex.sites:
            fail(f"quickstart {route}: unrouted sites {sorted(ex.sites - ex.routed)}")
        if eng.kernel_launches_per_step != predicted or set(counts) != expected:
            fail(f"quickstart {route}: {eng.kernel_launches_per_step} launches "
                 f"a step of {sorted(counts)}, predicted {predicted} of "
                 f"{sorted(expected)}")
        name = f"quickstart {cfg.name} {route}"
        serves[name] = (counts, by_shape, eng.step_dispatches)
        # the artifact saved, loaded and served again: the same tokens and
        # launches (the float32 one carries its step plan to disk)
        back, save_s, load_s, nbytes = save_and_load(art, dev)
        dispatch.reset_launch_count()  # counts of the loaded serve start here ...
        eng_l, res_l, _ = serve(back, dev, use_kernel=True, n_slots=BATCH,
                                prompts=prompts, max_new=16)
        torch.cuda.synchronize()
        counts_l = dispatch.launch_counts()  # ... and are read here
        if ([r.tokens for r in res_l] != [r.tokens for r in res]
                or counts_l != counts
                or eng_l.kernel_launches_per_step != predicted):
            fail(f"quickstart {route}: the loaded artifact serves other tokens "
                 f"or launches ({counts_l} against {counts})")
        loaded_pack_s = (eng_l.executor.step_plan(cfg).pack_s
                         if route == "plan" else None)
        del eng_l, back
        resumed = launcher_resume(art, dev) if route == "plan" else None
        lines.append(dict(serve=name, dtype=dtype, compress=summary,
                          launches_per_step=eng.kernel_launches_per_step,
                          predicted_launches_per_step=predicted,
                          launches=counts, n_layer_plans=eng.n_layer_plans,
                          tokens_equal_dense_effective=True,
                          round_trip=dict(file_bytes=nbytes, save_s=save_s,
                                          load_s=load_s, pack_s=loaded_pack_s,
                                          tokens_and_launches_equal=True),
                          launcher_resume=resumed,
                          ms_per_step=float(np.median(step_s[1:] or step_s)) * 1e3,
                          sample_tokens=res[0].tokens[res[0].prompt_len:]))
        del eng, art, plan
        gc.collect()
    return lines, rows, serves


def phase_compress(dev, trained=None):
    """``--only compress``: the compressor on the card's host, feeding the
    card.  Without ``trained`` (the full run passes its MLP training's) the
    MLP is first trained here, as ``train_mlp`` trains it."""
    from repro_torch.pipeline import runner

    t0 = time.perf_counter()
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    serves = {}
    if trained is None:  # K5's rows at the MLP's shapes are the train phase's
        line, *_, trained = phase_train_mlp(dev)
        emit(line)
    line, row, serves[MLP_SERVE] = phase_compress_mlp(dev, trained, timer, sm)
    emit(line)
    emit(phase_train_handoff(dev))
    rows = [row]
    olmo, orows, oserves = phase_compress_olmo(dev, timer, sm)
    rows += orows
    serves.update(oserves)
    runner.shutdown_workers(wait=True)
    emit(dict(phase="compress_quickstart_serves", serves=olmo))
    emit(dict(phase="compress", seconds=time.perf_counter() - t0))
    return rows, serves


# ------------------------------------- the examples, --compress, the dry run

EXAMPLES = Path(__file__).resolve().parent / "examples" / "torch"
# the reference's examples/quickstart.py prints these three lines
QUICKSTART_LINES = [
    "CSD shift-add baseline:        15501 additions",
    "LCC-FP: 7200 additions (ratio 2.15x, SNR 61.0 dB)",
    "LCC-FS: 6850 additions (ratio 2.26x, SNR 61.3 dB)"]
QUICKSTART_REL_ERR = "relative error 9.09e-04"
# the serve launcher's compressed path as scripts/ci_torch.sh drives it
LAUNCHER_COMPRESS = ["--reduced", "--compress", "--kernel", "--requests", "2",
                     "--max-new", "8", "--slots", "2"]
DRYRUN_RECORDS = 80  # 10 archs x 4 cells x 2 meshes
DRYRUN_REF_SKIPS = 14  # long_500k for 7 archs, on both meshes


def load_example(name: str):
    """``examples/torch/{name}.py`` as a module (its ``main(argv)``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: list[str]):
    """One example in process on the card, its launches counted from its
    start to its end: ``(result, printed lines, seconds, counts, by
    shape)``."""
    import contextlib
    import io

    mod = load_example(name)
    out = io.StringIO()
    dispatch.reset_launch_count()  # counts of the example start here ...
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = mod.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dispatch.launch_counts()  # ... and are read here
    by_shape = dispatch.launch_counts_by_shape()
    return res, out.getvalue().splitlines(), seconds, counts, by_shape


def shape_counts(by_shape) -> dict:
    """Launches by kernel and dimensions, for a phase's line."""
    return {f"{name} {list(key)}": n for (name, key), n in sorted(
        by_shape.items(), key=str)}


def phase_quickstart(dev, timer, sm):
    """``examples/torch/quickstart.py`` on the card: its adds lines the
    reference's letter for letter, its one K1 launch (N = 300, K = 16,
    B = 8) bit for bit the plain version summed in the kernel's order on
    the example's own input, and K1 at that shape held against its plain
    version (the row)."""
    res, lines, seconds, counts, by_shape = run_example("quickstart", [])
    if lines[:3] != QUICKSTART_LINES or QUICKSTART_REL_ERR not in lines[3]:
        fail(f"quickstart: printed {lines}")
    if counts != {"lcc_chain_matmul": 1}:
        fail(f"quickstart: launched {counts}, one lcc_chain_matmul expected")
    packed, x, y = res["packed"], res["x"], res["y_kernel"]
    ds = packed.on(dev)
    want = ordered_plain(ds, x, sm)[0][: packed.out_dim]
    for (c0, c1), w in ds.dense:  # apply_packed_decomposition's dense part
        want = want + w @ x[c0:c1]
    if not torch.equal(y, want):
        fail("quickstart: K1 differs from its plain version in the kernel's "
             f"order by {float((y - want).abs().max()):.3e}")
    row = kernel_case_chain("quickstart example W [300, 16]", packed,
                            np.random.default_rng(71), dev, timer, sm)
    row["serve"] = "quickstart example"
    line = dict(phase="quickstart", seconds=seconds, lines=lines,
                rel_err=res["rel_err"], launches=counts,
                launches_by_shape=shape_counts(by_shape),
                k1_equal_plain_in_kernel_order=True)
    return line, [row], {"quickstart example": (counts, by_shape, 1)}


def telemetry_gates(payload, spans, layers: int) -> dict:
    """scripts/ci_torch.sh's telemetry smoke on a serve's files: 2 spans
    ``ok``, 7 launches a layer a step (the plan route), a layer plan, 2
    requests ``ok``, the live roofline there."""
    m = payload["metrics"]
    got = dict(
        spans=[s["status"] for s in spans],
        launches_per_step=max(v["value"] for v in
                              m["serving_kernel_launches_per_step"]["values"]),
        layer_plans=m["serving_layer_plans"]["values"][0]["value"],
        requests=m["serving_requests_total"]["values"],
        achieved_adds_per_s=(payload["live_roofline"] or {}).get(
            "achieved_adds_per_s"))
    if (got["spans"] != ["ok", "ok"] or got["launches_per_step"] != 7 * layers
            or not got["layer_plans"] > 0
            or got["requests"] != [{"labels": {"status": "ok"}, "value": 2}]
            or not (got["achieved_adds_per_s"] or 0) > 0):
        fail(f"telemetry gates: {got}")
    return got


def phase_launcher_compress(dev, timer, sm):
    """The serve launcher's ``--reduced --compress --kernel`` in process on
    the card: Algorithm 1 over the reduced olmo-1b (the card's host), the
    report table printed, the artifact served through the float32 plan
    route with telemetry, scripts/ci_torch.sh's gates on its files; K6's
    stages, K7's norm and attention at the serve's dimensions (2 slots, a
    128-position view) against their plain versions (the rows)."""
    import contextlib
    import io
    import re
    import tempfile

    from repro_torch.launch import serve as serve_launcher

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        mpath, tpath = os.path.join(d, "m.json"), os.path.join(d, "t.jsonl")
        dispatch.reset_launch_count()  # counts of the launcher start here ...
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            eng = serve_launcher.main(LAUNCHER_COMPRESS + [
                "--metrics-out", mpath, "--trace-out", tpath])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dispatch.launch_counts()  # ... and are read here
        by_shape = dispatch.launch_counts_by_shape()
        payload = json.loads(Path(mpath).read_text())
        spans = [json.loads(line) for line in
                 Path(tpath).read_text().splitlines()]
    text = out.getvalue()
    art, cfg = eng.artifact, eng.cfg
    table = art.report.table()
    print(table, flush=True)
    if not text.startswith(table):
        fail("launcher --compress: the report table is not printed first")
    gates = telemetry_gates(payload, spans, cfg.n_layers)
    ex = eng.executor
    if ex.routed != ex.sites or set(counts) != set(PLAN):
        fail(f"launcher --compress: routed {len(ex.routed)}/{len(ex.sites)}, "
             f"launched {counts}")
    compress_s = float(re.search(r"compressed artifact: .*\(([0-9.]+)s\)",
                                 text).group(1))
    plan = ex.step_plan(cfg)
    rows = quickstart_rows(cfg, art, plan, dev, timer, sm, "plan",
                           serve_name="launcher_compress", batch=eng.n_slots,
                           smax=eng.max_len)
    prof = payload["profiler"]
    line = dict(phase="launcher_compress", argv=" ".join(LAUNCHER_COMPRESS),
                seconds=seconds, compress_s=compress_s,
                ms_per_step=prof["p50_ms"], profiler=prof, **gates,
                sites=len(art.records), lcc_adds=art.report.total_stage("lcc"),
                baseline_adds=art.report.total_baseline(),
                launches=counts, launches_by_shape=shape_counts(by_shape),
                summary_lines=[ln for ln in text.splitlines()
                               if ln.startswith(("req", "routed", "  live"))])
    return line, rows, {"launcher_compress": (counts, by_shape,
                                              eng.step_dispatches)}


def start_dryrun(out_path: str):
    """``launch/dryrun.py --arch all --shape all --mesh both`` in a process
    of its own on the host (the meta device; no card), started now and
    read at the end of the run (:func:`phase_dryrun`)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(Path(__file__).resolve().parent / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all",
         "--shape", "all", "--mesh", "both", "--out", out_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def phase_dryrun(started, out_path: str) -> dict:
    """The dry run's records: 80, zero FAIL (the reference's 14 long_500k
    SKIPs, the port's A7c SKIPs, the rest PASS with an H100 roofline)."""
    proc, t0 = started
    log, _ = proc.communicate(timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"dryrun: exit {proc.returncode}: {log[-2000:]}")
    recs = json.loads(Path(out_path).read_text())
    status = [r["status"] for r in recs]
    n_port = sum(r.get("refused_by") == "port" for r in recs)
    counts = dict(PASS=status.count("PASS"), SKIP=status.count("SKIP"),
                  FAIL=status.count("FAIL"))
    if (len(recs) != DRYRUN_RECORDS or counts["FAIL"]
            or counts["SKIP"] - n_port != DRYRUN_REF_SKIPS
            or any("roofline" not in r for r in recs if r["status"] == "PASS")):
        fail(f"dryrun: {len(recs)} records, {counts}, {n_port} port SKIPs: "
             + "; ".join(r.get("error", "") for r in recs
                         if r["status"] == "FAIL")[:2000])
    single = {f"{r['arch']} {r['shape']}": dict(
        dominant=r["dominant"], roofline_fraction=r["roofline_fraction"],
        step_s=max(r["roofline"].values()),
        coll_link_bytes=r["cost"]["coll_link_bytes"])
        for r in recs if r["status"] == "PASS" and r["mesh"] == "16x16"}
    return dict(phase="dryrun", seconds=seconds, records=len(recs), **counts,
                port_skips=n_port, summary=log.strip().splitlines()[-1],
                single_pod=single)


def phase_examples(dev):
    """``--only examples``: the three other examples in process on the card
    at their default arguments — the paper's MLP loop at full width (784-300
    -10: ProxSGD's K5 on fc1, 2 workers, 60 recovery steps), the reduced
    ResNet's Table I grid (served on dense-effective kernels: no launch)
    and the transformer example (its compressed reduced olmo-1b served
    through the plan route: K6, K7) — each with its seconds and launches by
    shape, every launch shape held against its plain version."""
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, serves, lines = [], {}, []
    res, out, seconds, counts, by_shape = run_example("mlp_mnist_compress", [])
    if set(counts) != {"group_prox"} or res["accuracy"]["dense"] < 0.9:
        fail(f"mlp example: launched {counts}, accuracy {res['accuracy']}")
    a, t = prox_input(np.random.default_rng(72), 784, 300, torch.float32, dev)
    rows.append(kernel_case_prox("mlp example fc1 [784, 300] float32", a, t,
                                 dev, timer, serve="mlp example"))
    serves["mlp example"] = (counts, by_shape, counts["group_prox"])
    lines.append(dict(example="mlp_mnist_compress", seconds=seconds,
                      launches=counts, launches_by_shape=shape_counts(by_shape),
                      accuracy=res["accuracy"], adds_ratio=res["adds_ratio"],
                      result=out[-1]))
    res, out, seconds, counts, by_shape = run_example("resnet_compress", [])
    if counts:
        fail(f"resnet example: launched {counts}; it serves dense-effective "
             "kernels")
    lines.append(dict(example="resnet_compress", seconds=seconds, launches={},
                      accuracy=res["accuracy"],
                      accuracy_effective=res["accuracy_effective"],
                      table1=res["table1"]))
    res, out, seconds, counts, by_shape = run_example(
        "transformer_compress_serve", [])
    eng, art = res["engine"], res["artifact"]
    if eng.executor.routed != eng.executor.sites or set(counts) != set(PLAN):
        fail(f"transformer example: launched {counts}")
    rows += quickstart_rows(eng.cfg, art, eng.executor.step_plan(eng.cfg), dev,
                            timer, sm, "plan", serve_name="transformer example",
                            batch=eng.n_slots, smax=eng.max_len)
    serves["transformer example"] = (counts, by_shape, eng.step_dispatches)
    lines.append(dict(example="transformer_compress_serve", seconds=seconds,
                      launches=counts, launches_by_shape=shape_counts(by_shape),
                      launches_per_step=eng.kernel_launches_per_step,
                      agreement=res["agreement"], adds_ratio=res["adds_ratio"]))
    emit(dict(phase="examples", examples=lines))
    return rows, serves


# ------------------------------------------ ResNet-34: conv units (K2)


RESNET_SIZE = 64  # TinyImageNet's 64 x 64 images
RESNET_CLASSES = 200
RESNET_BATCHES = (8, 32)
RESNET_GATED = 8  # the batch whose forward's launches the kernel rows hold
RESNET_METHODS = ("fk", "pk")
RESNET_SEED = 3
# fused logits vs the dense-effective forward (F.conv2d, float32, TF32
# off): both float32, each conv's channel sums in other orders, 36 convs deep
RESNET_TOL = 1e-3
# the reduced loop, the recipe of the JAX package's example
# (examples/resnet_compress.py): 512 textures of 24 x 24, 6 classes, 12
# epochs of SGD
SMALL_TRAIN = dict(n=512, size=24, classes=6, epochs=12, batch=64, lr=0.05)
SMALL_TEST = 128
RESNET_WORKERS = 4
# ResNet-34 compressed for real on every 32nd channel (the reference's
# conv_channel_subsample), under --only resnet
SAMPLED_SUBSAMPLE = 32


class ConvRecorder:
    """An executor proxy that keeps each conv site's input, stride and
    padding as the forward hands them over (the kernel rows rebuild each
    launch's input from them, as ``ConvLCC`` does)."""

    def __init__(self, ex):
        self.ex, self.seen = ex, {}

    def conv(self, name):
        cv = self.ex.conv(name)
        if cv is None:
            return None

        def run(h, stride=1, padding="SAME"):
            self.seen[name] = (h, stride, padding)
            return cv(h, stride=stride, padding=padding)
        return run

    def matvec(self, name):
        return self.ex.matvec(name)


def resnet_stage(name, cfg) -> str:
    """``stem``, ``stage1`` .. ``stage4`` of a conv site."""
    if not name.startswith("block"):
        return name
    i = int(name[len("block"):].split(".")[0])
    return f"stage{int(np.searchsorted(np.cumsum(cfg.stages), i, 'right')) + 1}"


def resnet_images(batch, seed, dev):
    """``batch`` TinyImageNet-shaped procedural textures (images, labels)."""
    from repro_torch.data.synthetic import textures_like

    x, y = textures_like(batch, size=RESNET_SIZE, classes=RESNET_CLASSES,
                         seed=seed)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def profile_forward(fn) -> dict:
    """One profiled forward (device activity only): device busy ms, K2's
    ms (its chain and reduce kernels) and the top kernels by device ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, _ = device_ms_by_name(prof)
    busy = sum(by_name.values())
    if busy <= 0:
        fail("the profiler reported no device time for the ResNet forward")
    k2 = sum(v for k, v in by_name.items()
             if "lcc_chain_kernel" in k or "lcc_reduce_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(device_busy_ms=busy, k2_device_ms=k2,
                top_device_ms={k.replace("(anonymous namespace)::", "")[:48]:
                               round(v, 4) for k, v in top})


def kernel_case_conv(label, cv, xs, dev, timer, sm, serve):
    """K2 at one conv site's launch: the site's group (one member a
    decomposed input channel) on the FK patches / PK windows ``ConvLCC``
    extracts from the site's input in the served forward.  Against its
    plain version (``SUM_TOL``), bit for bit in the kernel's order, and
    against the dense members (one ``bmm`` over ``[G, N, K_g] x [G, K_g,
    B]``, the library yardstick)."""
    pg = cv.group
    ds = pg.on(dev)
    args = (ds.idx, ds.exp, ds.sign, xs, ds.slice_c0, ds.slice_w, ds.chain_len)
    y = lcc_group_matmul(*args)
    torch.cuda.synchronize()
    err = check_close(label, y, lcc_group_matmul_plain(*args), SUM_TOL)
    if not torch.equal(y, ordered_plain(ds, xs, sm)):
        fail(f"{label}: kernel differs from the plain version summed in the "
             "kernel's own (fixed) slice order")
    torch.cuda.empty_cache()
    g, e, p, n, s = pg.idx.shape
    kg = pg.members[0].in_dim
    w_eff = torch.stack([decomposition_dense(m, dev) for m in pg.members])
    xg = xs.view(g, kg, xs.shape[1])
    check_close(label + " vs dense", y[:, : w_eff.shape[1]],
                torch.bmm(w_eff, xg), 1e-4)
    del y
    k, b = xs.shape
    return kernel_row(
        "lcc_group_matmul", label,
        dict(G=g, E=e, P=p, N=n, S=s, K=k, K_g=kg, B=b, method=cv.method),
        (g, e, p, n, s, k, b), err, True,
        lambda: lcc_group_matmul(*args), lambda: lcc_group_matmul_plain(*args),
        lambda: torch.bmm(w_eff, xg), chain_bound(pg.members, k, b),
        timer, serve=serve,
        warm_l2_ms=timer(lambda: lcc_group_matmul(*args), cold=False))


def k2_ms_by_stage(cfg, ex, rec, timer) -> dict:
    """K2's device ms a forward by stage: every conv site's launch at its
    served input, timed alone (median, L2 flushed), summed by stage."""
    out = {}
    for name, (h, stride, padding) in rec.seen.items():
        cv = ex._convs[name]
        xs = cv.group_input(h, stride=stride, padding=padding)
        ds = cv.group.on(xs.device)
        args = (ds.idx, ds.exp, ds.sign, xs, ds.slice_c0, ds.slice_w,
                ds.chain_len)
        st = resnet_stage(name, cfg)
        out[st] = out.get(st, 0.0) + timer(lambda: lcc_group_matmul(*args))
        del xs, args
    torch.cuda.empty_cache()
    return out


def phase_resnet_serve(dev, method, timer, sm, batches=RESNET_BATCHES):
    """ResNet-34 (``resnet34_config(200)``) at full width on the seeded conv
    artifact in ``method`` (FK or PK), TinyImageNet-shaped textures: the
    forward at B = 8 with its counts reset just before and read just after
    (36 K2, the head's K1 and its region prep), fused logits against the
    dense-effective ``F.conv2d`` forward; K2 at every distinct launch shape
    of that forward, the head's K1 and K3 as kernel rows; at each of
    ``batches`` ms a forward (CUDA events around one forward, median of 3),
    images/s, peak device bytes, K2 ms by stage, a profiled forward and the
    cuDNN forward beside."""
    from repro_torch.models.resnet import resnet34_config, resnet_forward
    from repro_torch.testing import seeded_conv_artifact

    cfg = resnet34_config(classes=RESNET_CLASSES)
    serve = f"resnet-34 {method}"
    t_phase = t0 = time.perf_counter()
    art = seeded_conv_artifact(cfg, seed=RESNET_SEED, device=dev, method=method)
    fixture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = CompressedExecutor(art, device=dev)
    pack_s = time.perf_counter() - t0
    head, k_head = ex._matvecs["head"], cfg.widths[-1]
    want = {"lcc_group_matmul": len(ex._convs), "lcc_chain_matmul": 1}
    if head.prep.launches(torch.empty(k_head, 1)):
        want["region_prep"] = 1
    x8, _ = resnet_images(RESNET_GATED, RESNET_GATED, dev)
    rec = ConvRecorder(ex)
    with torch.no_grad():
        t0 = time.perf_counter()
        resnet_forward(art.params, x8, executor=rec)  # uploads the groups
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        dispatch.reset_launch_count()  # counts of the served forward start here ...
        y8 = resnet_forward(art.params, x8, executor=ex)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()  # ... and are read here
        by_shape = dispatch.launch_counts_by_shape()
        if counts != want:
            fail(f"{serve}: the forward launched {counts}, predicted {want}")
        if ex.routed != ex.sites or len(ex.sites) != len(art.records):
            fail(f"{serve}: routed {len(ex.routed)} of {len(ex.sites)} sites")
        err = check_close(f"{serve} fused vs dense-effective", y8,
                          resnet_forward(art.params, x8), RESNET_TOL)
        rows, shapes = [], set()
        for name, (h, stride, padding) in rec.seen.items():
            cv = ex._convs[name]
            xs = cv.group_input(h, stride=stride, padding=padding)
            key = (*cv.group.idx.shape, *xs.shape)
            if key not in shapes:
                shapes.add(key)
                g, _, _, n, _ = cv.group.idx.shape
                rows.append(kernel_case_conv(
                    f"{serve} {name} G={g} N={n} B={xs.shape[1]}", cv, xs,
                    dev, timer, sm, serve))
            del xs
        pk = head.packed
        row = kernel_case_chain(
            f"{serve} head E={pk.idx.shape[0]} N={pk.out_dim} K={pk.in_dim} "
            f"B={RESNET_GATED}", pk, np.random.default_rng(61), dev, timer,
            sm, batch=RESNET_GATED)
        rows.append({**row, "serve": serve})
        if "region_prep" in want:
            rows.append(kernel_case_prep(
                f"{serve} head prep K={k_head} B={RESNET_GATED}", head.prep,
                k_head, RESNET_GATED, torch.float32, False, dev, timer,
                serve=serve))
    del rec, y8
    per_batch = {}
    short = Timer(dev, iters=3)
    for b in batches:
        xb, _ = resnet_images(b, b, dev)
        rec_b = ConvRecorder(ex)
        with torch.no_grad():
            dispatch.reset_launch_count()
            yb = resnet_forward(art.params, xb, executor=rec_b)
            torch.cuda.synchronize()
            cb = dispatch.launch_counts()
            if cb != want:
                fail(f"{serve} B={b}: the forward launched {cb}, predicted "
                     f"{want}")
            err_b = check_close(f"{serve} B={b} fused vs dense-effective", yb,
                                resnet_forward(art.params, xb), RESNET_TOL)
            del yb
            torch.cuda.reset_peak_memory_stats(dev)
            fused = short(lambda: resnet_forward(art.params, xb, executor=ex),
                          cold=False)
            peak = torch.cuda.max_memory_allocated(dev)
            cudnn = short(lambda: resnet_forward(art.params, xb), cold=False)
            prof = profile_forward(
                lambda: resnet_forward(art.params, xb, executor=ex))
            k2 = k2_ms_by_stage(cfg, ex, rec_b, short)
        per_batch[b] = dict(
            ms_per_forward=fused, images_per_s=b / fused * 1e3,
            cudnn_ms_per_forward=cudnn, cudnn_images_per_s=b / cudnn * 1e3,
            peak_device_bytes=peak, launches=cb,
            logits_vs_dense_effective=err_b,
            k2_ms_by_stage=k2, k2_ms=sum(k2.values()),
            profiled=prof,
            device_idle_share=max(0.0, 1.0 - prof["device_busy_ms"] / fused))
        del rec_b, xb
        torch.cuda.empty_cache()
    stream_bytes = sum(cv.group.idx.nbytes + cv.group.exp.nbytes
                       + cv.group.sign.nbytes for cv in ex._convs.values())
    line = dict(phase="resnet_serve", serve=serve, model="resnet-34",
                method=method, classes=RESNET_CLASSES,
                image=[3, RESNET_SIZE, RESNET_SIZE],
                conv_sites=len(ex._convs),
                channels=sum(len(cv.channels) for cv in ex._convs.values()),
                fixture_s=fixture_s, pack_s=pack_s, first_forward_s=first_s,
                k2_stream_bytes=stream_bytes,
                launches_per_forward=counts, predicted=want,
                routed_equals_sites=True, logits_vs_dense_effective=err,
                tol=RESNET_TOL, k2_shapes=len(shapes), per_batch=per_batch,
                seconds=time.perf_counter() - t_phase)
    del ex, art
    gc.collect()
    torch.cuda.empty_cache()
    return line, rows, (counts, by_shape, 1)


def train_resnet_small(dev):
    """The reduced ResNet trained on textures as the reference's example
    trains it (SGD, momentum 0.9, lr 0.05, batch 64, 12 epochs).  Returns
    ``(params, cfg, (x_test, y_test), dense accuracy, train s, mean loss
    an epoch)``."""
    from repro_torch.data.synthetic import batches, textures_like
    from repro_torch.models.resnet import (init_resnet, resnet_loss,
                                           resnet_small_config)
    from repro_torch.optim.optimizers import sgd, tree_leaves, tree_map

    t = SMALL_TRAIN
    cfg = resnet_small_config(classes=t["classes"])
    xs, ys = textures_like(t["n"], size=t["size"], classes=t["classes"], seed=0)
    xte, yte = textures_like(SMALL_TEST, size=t["size"], classes=t["classes"],
                             seed=1)
    params = init_resnet(torch.Generator().manual_seed(0), cfg, dev)
    opt = sgd(momentum=0.9)
    state = opt.init(params)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    # the loss sits near ln 6 for a few epochs before it falls, so a run
    # amplifies rounding: cuDNN's deterministic algorithms make the card's
    # run repeatable from call to call
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    losses = []
    t0 = time.perf_counter()
    for ep in range(t["epochs"]):
        ep_loss = []
        for xb, yb in batches(xs, ys, t["batch"], seed=ep):
            loss = resnet_loss(params, torch.from_numpy(xb).to(dev),
                               torch.from_numpy(yb).to(dev))
            it = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda _: next(it), params)
            params, state = opt.update(grads, state, params, t["lr"])
            ep_loss.append(loss.detach())
        losses.append(float(torch.stack(ep_loss).mean()))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was
    params = tree_map(lambda p: p.detach(), params)
    test = (torch.from_numpy(xte).to(dev), torch.from_numpy(yte).to(dev))
    return params, cfg, test, resnet_accuracy(params, test), train_s, losses


def resnet_accuracy(params, test, executor=None) -> float:
    from repro_torch.models.resnet import resnet_forward

    with torch.no_grad():
        logits = resnet_forward(params, test[0], executor=executor)
    return float((torch.argmax(logits, -1) == test[1]).float().mean())


def phase_resnet_small(dev):
    """The paper's Table I loop on the reduced ResNet, for real: trained on
    the card, compressed on its host (the residual blocks, FK/PK x FP/FS, no
    sharing, :data:`RESNET_WORKERS` workers), each artifact saved, loaded
    and served through ``ConvLCC`` (FP: one K2 launch a block conv; FS: the
    members' dense fallbacks); accuracy dense -> effective kernels -> fused,
    the fused logits within ``STEP_TOL`` of the effective forward."""
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.models.resnet import resnet_forward

    t_phase = time.perf_counter()
    params, cfg, test, acc_dense, train_s, losses = train_resnet_small(dev)
    grid = []
    for method in RESNET_METHODS:
        for alg in ("fp", "fs"):
            t0 = time.perf_counter()
            art = api.compress_model(
                params, cfg, CompressionConfig(algorithm=alg,
                                               conv_method=method,
                                               weight_sharing=False),
                include="block", n_workers=RESNET_WORKERS, build_packed=False)
            wall = time.perf_counter() - t0
            back, save_s, load_s, nbytes = save_and_load(art, dev)
            ex = CompressedExecutor(back, device=dev)
            with torch.no_grad():
                dispatch.reset_launch_count()
                fused = resnet_forward(back.params, test[0], executor=ex)
                torch.cuda.synchronize()
                counts = dispatch.launch_counts()
                eff = resnet_forward(back.params, test[0])
            k2 = counts.get("lcc_group_matmul", 0)
            if ex.routed != ex.sites or k2 != (len(ex._convs) if alg == "fp"
                                               else 0):
                fail(f"resnet-small {method}/{alg}: routed "
                     f"{len(ex.routed)}/{len(ex.sites)}, launches {counts}")
            err = check_close(f"resnet-small {method}/{alg} fused vs effective",
                              fused, eff, STEP_TOL)
            rep = art.report
            grid.append(dict(
                method=method, alg=alg, adds_ratio=rep.ratio("lcc"),
                baseline_adds=rep.total_baseline(),
                lcc_adds=rep.total_stage("lcc"), compress_wall_s=wall,
                jobs=art.pipeline_stats["jobs"], save_s=save_s, load_s=load_s,
                bytes=nbytes, launches=counts, fused_vs_effective=err,
                accuracy=dict(dense=acc_dense,
                              effective=float((torch.argmax(eff, -1) == test[1])
                                              .float().mean()),
                              fused=float((torch.argmax(fused, -1) == test[1])
                                          .float().mean()))))
            del art, back, ex
    return dict(phase="resnet_small", config=dict(stages=list(cfg.stages),
                                                  widths=list(cfg.widths),
                                                  classes=cfg.classes),
                train=dict(SMALL_TRAIN, test=SMALL_TEST, train_s=train_s,
                           loss_by_epoch=losses, accuracy=acc_dense),
                workers=RESNET_WORKERS, table1=grid,
                seconds=time.perf_counter() - t_phase)


def phase_resnet_sampled(dev, timer):
    """ResNet-34 at full width compressed for real on every
    :data:`SAMPLED_SUBSAMPLE`-th input channel (FK, FP, no sharing; random
    He-normal weights), served through ``ConvLCC`` at B = 8: the sampled
    channels' chains through K2 beside the residual ``F.conv2d`` of the
    others, the head through K1; logits against the dense-effective
    forward."""
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.models.resnet import (init_resnet, resnet34_config,
                                           resnet_forward)

    cfg = resnet34_config(classes=RESNET_CLASSES)
    t_phase = time.perf_counter()
    params = init_resnet(torch.Generator().manual_seed(1), cfg, dev)
    t0 = time.perf_counter()
    art = api.compress_model(
        params, cfg, CompressionConfig(algorithm="fp", conv_method="fk",
                                       weight_sharing=False),
        conv_channel_subsample=SAMPLED_SUBSAMPLE, n_workers=RESNET_WORKERS)
    wall = time.perf_counter() - t0
    ex = CompressedExecutor(art, device=dev)
    x, _ = resnet_images(RESNET_GATED, 99, dev)
    with torch.no_grad():
        resnet_forward(art.params, x, executor=ex)
        torch.cuda.synchronize()
        dispatch.reset_launch_count()
        fused = resnet_forward(art.params, x, executor=ex)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        err = check_close("resnet-34 sampled fused vs dense-effective", fused,
                          resnet_forward(art.params, x), RESNET_TOL)
        ms = timer(lambda: resnet_forward(art.params, x, executor=ex),
                   cold=False)
    if counts.get("lcc_group_matmul") != len(ex._convs) or \
            ex.routed != ex.sites:
        fail(f"resnet-34 sampled: launches {counts}, routed "
             f"{len(ex.routed)}/{len(ex.sites)}")
    rep = art.report
    return dict(phase="resnet_sampled", subsample=SAMPLED_SUBSAMPLE,
                channels=sum(len(cv.channels) for cv in ex._convs.values()),
                residual_sites=sum(cv.rest is not None
                                   for cv in ex._convs.values()),
                compress_wall_s=wall, jobs=art.pipeline_stats["jobs"],
                adds_ratio=rep.ratio("lcc"), baseline_adds=rep.total_baseline(),
                lcc_adds=rep.total_stage("lcc"), launches_per_forward=counts,
                logits_vs_dense_effective=err, tol=RESNET_TOL,
                ms_per_forward=ms, batch=RESNET_GATED,
                seconds=time.perf_counter() - t_phase)


def run_resnet(dev, full: bool):
    """ResNet-34 served at full width in FK and PK (the kernel rows of both
    serves, their forwards timed at B = 8, FK's also at 32) and the reduced
    ResNet's Table I loop for real; ``full`` (``--only resnet``) adds PK's
    forward at B = 32 and ResNet-34 compressed on sampled channels, which
    the whole script has no time for."""
    from repro_torch.pipeline import runner

    t0 = time.perf_counter()
    timer = Timer(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, serves = [], {}
    for method in RESNET_METHODS:
        batches = (RESNET_BATCHES if full or method == "fk"
                   else RESNET_BATCHES[:1])
        line, mrows, serves[line["serve"]] = phase_resnet_serve(
            dev, method, timer, sm, batches)
        emit(line)
        rows += mrows
    emit(phase_resnet_small(dev))
    if full:
        emit(phase_resnet_sampled(dev, Timer(dev, iters=3)))
    runner.shutdown_workers(wait=True)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict(phase="resnet", seconds=time.perf_counter() - t0))
    return rows, serves


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth of the olmo-1b serves (never the width)")
    ap.add_argument("--only", choices=("kernels", "chain", "stage",
                                       "attention", "prep", "artifact",
                                       "prefix", "mixtral", "deepseek",
                                       "qwen", "dense", "recurrent", "audio",
                                       "train", "distributed", "compress",
                                       "resnet", "examples"),
                    default=None,
                    help="examples: examples/torch/'s MLP loop (full "
                         "width), ResNet grid and transformer example in "
                         "process at their default arguments, each one's "
                         "seconds and launches by shape, every launch shape "
                         "held against its plain version; kernels: stop after olmo-1b's kernel phase (K4's "
                         "per-factor route included); chain: K1/K2 at every "
                         "shape the ten per-region serves launch them at, "
                         "no fixture and no serve; stage: K6 alone at the "
                         "shapes of the six float32 plan routes and "
                         "on the hand-built stages, no serve; attention: "
                         "K7's attention alone at the olmo-1b and "
                         "mixtral-8x22b plan serves' shapes and at their "
                         "long caches (S = 2048, 4096; random and full), and "
                         "K8's route alone, no fixture and no serve; prep: "
                         "K3's region prep alone at every region of the "
                         "ten per-region serves and K7's norm alone at "
                         "the five plan serves' shapes, no fixture and no "
                         "serve; artifact: olmo-1b's full-width float32 "
                         "fixture cut to ARTIFACT_LAYERS layers and its "
                         "step plan saved, loaded through "
                         "the map and served on both routes, bit for bit "
                         "the in-memory serves; prefix: olmo-1b's "
                         "full-width fixture served with the prefix cache "
                         "off and on (four prompts of one 96-token head), "
                         "float32 plan and bf16 per-region, then the "
                         "reduced deepseek-v2-lite warm == cold and olmo-1b "
                         "tokenwise == bulk; "
                         "mixtral: run the "
                         "mixtral-8x22b phases alone; deepseek: the "
                         "deepseek-v2-lite-16b phases alone; qwen: the "
                         "qwen2.5-3b (both routes) and qwen2-vl-7b "
                         "(per-region, bf16 and float32) phases alone; "
                         "dense: llama3.2-3b and yi-9b at full width cut to "
                         "DENSE_LAYERS layers on both routes (left out of "
                         "the full run); recurrent: rwkv6-1.6b (ssm, "
                         "RWKV_LAYERS layers) and zamba2-7b (hybrid, "
                         "ZAMBA_LAYERS layers: a group, the shared block, "
                         "a tail layer) at full width on the per-region "
                         "route, float32 and bf16 (the full run leaves the "
                         "bf16 serves out), tokenwise prefill; audio: "
                         "whisper-small uncut (12 + 12 layers) at full "
                         "width on the per-region route, float32 and bf16, "
                         "8 slots over 1500 encoder positions, each slot's "
                         "cross-KV from the port's encoder (the full run "
                         "cuts it to WHISPER_LAYERS and serves float32 "
                         "only); train: the "
                         "training phases alone (olmo-1b uncut); "
                         "distributed: ServingEngine(mesh=) over a one-rank "
                         "NCCL 1x1 mesh == unsharded bit for bit (olmo-1b "
                         "at 2 layers and uncut on both routes, mixtral "
                         "moe_manual at 1 layer), then olmo-1b training at "
                         "full width on a one-rank NCCL mesh (the meshed "
                         "step == the unsharded step over 3 steps, the "
                         "compressed step at 1x1x1 and compressed_psum "
                         "against the CPU, GPipe and the overlapped matmul "
                         "at one rank, the launcher's --mesh flags); "
                         "compress: the compressor "
                         "(the paper's MLP trained, compressed at full width "
                         "at 1 and 4 workers, fc1 served through K1, then "
                         "recovered (60 steps) and served again; the train "
                         "launcher's --compress-out --recover run; the "
                         "quickstart olmo-1b compressed and served on both "
                         "routes; each artifact saved, loaded and served "
                         "again; the compress launcher SIGKILLed and "
                         "resumed); resnet: ResNet-34 served at full width "
                         "in FK and PK on the seeded conv artifact (K2 at "
                         "every conv shape, the head's K1 and K3), the "
                         "reduced ResNet's Table I loop, and, left out of "
                         "the full run, PK's forward at B = 32 and ResNet-34 "
                         "on sampled channels (no final ok line in any case)")
    args = ap.parse_args()

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this script measures "
                         "the GPU path and has no CPU fallback")
    dev = torch.device("cuda", 0)
    # float32 products in full float32, never TF32, for every yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.load()
    emit(dict(phase="device_and_build", card=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              build_seconds=build.last_build_seconds,
              sources=[p.name for p in build.sources()]))

    rows, serves, trained = [], {}, None
    if args.only == "examples":
        rows, serves = phase_examples(dev)
        emit(dict(kernels=kernel_rows(rows, serves)))
        emit(dict(phase="done", seconds=time.perf_counter() - t_start))
        print(smi, flush=True)
        return
    dryrun = None
    if args.only is None:  # on the host, beside the card's phases
        dryrun_out = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                                  f"chip_smoke_dryrun_{os.getpid()}.json")
        dryrun = start_dryrun(dryrun_out)
    if args.only in ("chain", "stage", "attention", "prep"):
        emit(dict(chain=phase_chain, stage=phase_stage,
                  attention=phase_attention, prep=phase_prep)[args.only](dev))
        print(smi, flush=True)
        return
    if args.only in ("artifact", "prefix"):
        base = get_arch("olmo-1b")
        if args.layers is not None:
            base = replace(base, n_layers=args.layers)
        if args.only == "prefix":
            cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
            art32 = seeded_artifact(cfg32, seed=2, device=dev)
            # the step plan packed into the artifact's plans, as the serves do
            CompressedExecutor(art32, device=dev).step_plan(cfg32)
            emit(phase_prefix(dev, base, art32)[0])
        else:
            emit(phase_artifact(dev, base))
        print(smi, flush=True)
        return
    if args.only is None:
        emit(phase_attention(dev))
        gc.collect()
        torch.cuda.empty_cache()
    if args.only is None or args.only == "kernels":
        if args.only == "kernels":
            base = get_arch("olmo-1b")
            if args.layers is not None:
                base = replace(base, n_layers=args.layers)
            cfg32 = replace(base, param_dtype="float32", compute_dtype="float32")
            art32 = seeded_artifact(cfg32, seed=2, device=dev)
            plan = CompressedExecutor(art32, device=dev).step_plan(cfg32)
            krows = phase_kernels(dev, art32, plan,
                                  reduced_config(get_arch("olmo-1b"), vocab=256))
            krows += phase_factor_route(dev, art32, Timer(dev))[0]
            emit(dict(phase="kernels", rows=krows))
            return
        rows, serves = run_olmo(dev, args.layers)
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "mixtral"):
        mrows, mserves = run_mixtral(dev)
        rows += mrows
        serves.update(mserves)
        del mrows, mserves
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "deepseek"):
        drows, dserves = run_deepseek(dev)
        rows += drows
        serves.update(dserves)
        del drows, dserves
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "qwen"):
        qrows, qserves = run_qwen(dev)
        rows += qrows
        serves.update(qserves)
        del qrows, qserves
        gc.collect()
        torch.cuda.empty_cache()
    if args.only == "dense":
        rows, serves = run_dense(dev)
    if args.only in (None, "recurrent"):
        srows, sserves = run_recurrent(dev, bf16=args.only == "recurrent")
        rows += srows
        serves.update(sserves)
        del srows, sserves
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "audio"):
        arows, aserves = run_audio(dev, full=args.only == "audio")
        rows += arows
        serves.update(aserves)
        del arows, aserves
        gc.collect()
        torch.cuda.empty_cache()
    if args.only == "distributed":
        emit(phase_mesh_distributed(dev))
        emit(phase_distributed(dev))
        emit(dict(phase="done", seconds=time.perf_counter() - t_start,
                  host_peak_rss_bytes=host_peak_rss_bytes()))
        print(smi, flush=True)
        return
    if args.only in (None, "train"):
        trows, tserves, trained = run_train(
            dev, TRAIN_LAYERS if args.only is None else None)
        rows += trows
        serves.update(tserves)
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "compress"):
        crows, cserves = phase_compress(dev, trained)
        rows += crows
        serves.update(cserves)
        gc.collect()
        torch.cuda.empty_cache()
    if args.only is None:
        timer = Timer(dev)
        sm = torch.cuda.get_device_properties(dev).multi_processor_count
        for phase in (phase_quickstart, phase_launcher_compress):
            line, prows, pserves = phase(dev, timer, sm)
            emit(line)
            rows += prows
            serves.update(pserves)
        del timer
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "resnet"):
        rrows, rserves = run_resnet(dev, full=args.only == "resnet")
        rows += rrows
        serves.update(rserves)

    if dryrun is not None:
        emit(phase_dryrun(dryrun, dryrun_out))
        os.remove(dryrun_out)
    # the whole steps and K9 at the serves' dimensions: compositions of the
    # kernels below, with no launch of their own
    emit(dict(phase="compositions",
              rows=[r for r in rows if r["name"] in COMPOSITE]))
    # the kernels of the main paths at the dimensions they gave them:
    # ``launches`` is what a serve launched at exactly the row's dimensions
    kernels = kernel_rows(rows, serves)
    emit(dict(phase="done", seconds=time.perf_counter() - t_start,
              host_peak_rss_bytes=host_peak_rss_bytes()))
    emit(dict(kernels=kernels))
    print(smi, flush=True)
    if args.only is not None:
        return
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
