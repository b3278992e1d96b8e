"""Batched serving engine: prefill + decode with slot-based continuous batching.

The engine keeps a fixed decode batch of ``n_slots``; finished sequences free
their slot and queued requests are prefilled into it (one bulk ``api.prefill``
writes the slot's KV cache in a single forward; ``bulk_prefill=False`` on a
contiguous engine runs one decode step a prompt token instead, as the
recurrent families — rwkv6's ssm, zamba2's hybrid — and whisper's decoder
always do: their contiguous state is reset and then advanced for the slot
alone; whisper's static cross-KV, which the caller writes per slot before
``submit``, is never reset).  Decoding
is **device-side**: one eager step function runs the forward pass,
greedy/temperature sampling (per-request keys, so draws are independent of
slot order and of which other requests are in flight), position/budget
bookkeeping and the EOS/headroom ``done`` flags — the host receives a
single small packed ``[3, n_slots]`` tensor (sampled token + emit/done
masks) per step instead of round-tripping logits.  The KV state is updated
in place.

Paged engines (``kv_block``, the default) keep the cache in a block pool
(:mod:`repro_torch.serving.kvpool`) with a **prefix cache** (on by default,
as in the reference): a prompt's full blocks are registered under their
exact token chain once prefilled; a later prompt that shares them maps the
same blocks (copy-on-write for a partly shared last block) and prefills
only its tail, in one ``api.prefill_extend`` forward against the gathered
resident prefix.  Windowed attention turns sharing off (the ring rewrites
shared blocks as it wraps).

Scheduling (queues, priorities, admission, streaming callbacks, failed-request
isolation) lives in :class:`repro_torch.serving.scheduler.Scheduler`;
``generate()`` is a thin convenience wrapper over it.

Compressed serving is artifact-driven: ``ServingEngine(artifact=art)`` builds
a site-keyed :class:`~repro_torch.serving.executor.CompressedExecutor` over
the artifact and the decode path consults it inside the step — for float32
configs the whole-step layer plan (``stage_matmul`` / ``step_plan_matmul``),
otherwise attention q/k/v/o and FFN gate/up/down as fused per-region launches
(``lcc_chain_matmul`` / ``lcc_group_matmul``); MLA models take the per-region
attention and, in float32, one expert plan a layer (``moe_plan_matmul``):
the shift-add runtime the paper targets either way.  A bulk prefill runs on
the artifact's dense-effective weights; the recurrent families' tokenwise
prefill runs through the executor, as their decode steps do.

Telemetry (:mod:`repro_torch.obs`), as in the reference: ``metrics=None``
builds a registry per engine, ``metrics=False`` turns telemetry off, a
``MetricsRegistry`` passed in is shared; ``tracer=True`` adds a request
tracer on the same registry, which the scheduler drives.  The step
profiler times every decode step (``fence_every``: its fencing period).

Multi-device serving: ``mesh=`` (a :class:`~repro_torch.distributed
.device_mesh.Mesh` of this process's group; one rank a device) serves the
dense family and the GQA MoE over the ranks.  Every rank builds the same
engine from the same whole params or artifact and runs the same host code
(scheduler, pool, block tables, slot mirrors) on the same requests.  Each
keeps on its device only its chunk of each parameter
(:func:`~repro_torch.distributed.sharding.params_pspecs`, computed through
:mod:`repro_torch.distributed.tp`) and of the decode state
(:func:`~repro_torch.distributed.sharding.decode_state_pspecs`), with one
exception: a paged pool keeps its block axis whole on every rank (any slot
may map any block, and a prefix block is shared across slots), so every
rank runs every admission's prefill and copy-on-write.  A decode step runs
on the rank's slots (:func:`~repro_torch.distributed.sharding
.plan_batch_spec`; all of them when the slots do not divide, and always for
the MoE family, whose routing capacity is global — the reference's
``replicate`` rule), and the packed ``[3, n_slots]`` is gathered before its
one host copy.  Compressed sites, step plans and their stage buffers stay
whole on every rank.  Refused under ``mesh=``: the MLA, vlm, ssm, hybrid
and audio families and the tokenwise prefill.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tp
from repro_torch.distributed.placement import (chunk_slices, gather_leaf,
                                               shard_leaf)
from repro_torch.distributed.sharding import (P, decode_state_pspecs,
                                              plan_batch_spec)
from repro_torch.kernels import dispatch
from repro_torch.models import api
from repro_torch.obs import MetricsRegistry, RequestTracer, StepProfiler
from repro_torch.serving.executor import CompressedExecutor
from repro_torch.serving.kvpool import KVPool, empty_stats

__all__ = ["ServingEngine", "GenerationResult", "StepEvent"]


@dataclass
class GenerationResult:
    tokens: list[int]
    prompt_len: int
    finished: bool
    error: str | None = None
    # per-request telemetry the engine learned while serving this request
    # (prefill_s, cached_tokens, blocks_grown, cancelled, exhausted, ...)
    stats: dict = field(default_factory=dict)


@dataclass(frozen=True)
class StepEvent:
    """One slot's outcome of a decode step: ``token is None`` means the slot
    finished without emitting (no decode headroom)."""
    rid: int
    token: int | None
    finished: bool


class ServingEngine:
    """``ServingEngine(params, cfg)`` serves raw weights; ``ServingEngine(
    artifact=compressed_model)`` serves a compression artifact (params and
    config come from the artifact, and every compressed site runs on the fused
    LCC kernel path unless ``use_kernel=False``).  Everything lives on
    ``device`` (the GPU unless told otherwise); ``params`` must already be
    there.  ``mesh=`` serves over a device mesh (see the module docstring):
    ``params`` are whole, and each rank keeps its chunks on the mesh's
    device."""

    def __init__(self, params=None, cfg: ArchConfig | None = None, *,
                 artifact=None, n_slots: int = 8,
                 max_len: int = 512, eos_id: int | None = None,
                 temperature: float = 0.0, seed: int = 0,
                 use_kernel: bool = True, bulk_prefill: bool = True,
                 mesh=None, kv_block: int | None = 16,
                 kv_blocks: int | None = None, prefix_cache: bool = True,
                 metrics=None, tracer=None, fence_every: int = 32,
                 device="cuda"):
        if artifact is not None:
            if cfg is None:
                cfg = artifact.config
            if params is None:
                params = artifact.params
        if params is None or cfg is None:
            raise ValueError("ServingEngine needs (params, cfg) or artifact=...")
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            self.device = _mesh_device(mesh, cfg, bulk_prefill, self.device)
        self.params = params
        self.cfg = cfg
        self.artifact = artifact
        self.n_slots = n_slots
        self.max_len = max_len
        # default per-request decode budget (submit()/Scheduler may override
        # per request); bounded by max_len anyway
        self.max_new = max_len
        self.eos = eos_id
        self.temp = temperature
        self.bulk_prefill = bulk_prefill
        self.seed = seed
        # paged KV: the cache lives in a block pool (kv_block=None restores
        # the contiguous per-slot slabs; the tokenwise prefill needs them)
        self.paged = (kv_block is not None and bulk_prefill
                      and api.paged_supported(cfg))
        self.pool: KVPool | None = None
        if self.paged:
            bs, mb, nb = api.paged_layout(cfg, max_len, kv_block, kv_blocks,
                                          n_slots)
            self.pool = KVPool(
                n_slots=n_slots, n_blocks=nb - 1, block_size=bs, view_blocks=mb,
                # the tail-extend prefill has no mrope path; windowed rings
                # rewrite shared prefixes as they wrap — both disable sharing
                prefix_cache=(prefix_cache and cfg.pos in ("rope", "none")),
                windowed=cfg.attn_window is not None)
            self.state = api.init_decode_state(cfg, n_slots, max_len,
                                               kv_block=kv_block,
                                               kv_blocks=kv_blocks,
                                               device=self.device)
            self._tbl_host = np.zeros((n_slots, mb), np.int32)
        else:
            self.state = api.init_decode_state(cfg, n_slots, max_len,
                                               device=self.device)
        self._lo, self._hi = 0, n_slots  # this rank's slots
        if mesh is not None:
            self._place(params)
        # the per-token cache leaves a prefill writes (and a paged engine
        # keeps in its pool): MLA caches its latents
        self._cache_leaves = (("c_kv", "k_rope") if "c_kv" in self.state
                              else ("k", "v"))
        # host mirrors of the device-side per-slot control state
        self.pos = np.zeros(n_slots, np.int64)
        self.active = np.zeros(n_slots, bool)
        self._last_tok = np.zeros(n_slots, np.int64)
        self._new_count = np.zeros(n_slots, np.int64)
        self._max_new_arr = np.full(n_slots, self.max_new, np.int64)
        self._temp_arr = np.full(n_slots, temperature, np.float32)
        self._keys = np.zeros(n_slots, np.int64)
        self._ctrl_dev = None  # device copies of the submit-time-only arrays
        self._slot_dev = None  # device (last_tok, pos, active, new_count),
        # carried across steps; None => re-upload from the host mirrors
        self.results: dict[int, GenerationResult] = {}
        self.slot_req: dict[int, int] = {}
        self._next_req = 0
        self.executor = (self._build_executor(artifact, self.device)
                         if use_kernel else None)
        self.step_dispatches = 0  # decode steps run (observability)
        self._step_launches = 0  # kernel launches of the newest decode step
        # telemetry: metrics=None -> fresh per-engine registry; metrics=False
        # -> fully off (the A/B baseline for overhead measurement); any
        # MetricsRegistry -> shared.  tracer=True builds a RequestTracer
        # publishing into the same registry; the scheduler reads engine.tracer.
        if metrics is False:
            self.metrics = None
        else:
            self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.profiler = (StepProfiler(fence_every=fence_every)
                         if self.metrics is not None else None)
        if tracer is True:
            self.tracer: RequestTracer | None = RequestTracer(
                metrics=self.metrics)
        else:
            self.tracer = tracer or None
        m = self.metrics
        if m is not None:
            # pre-resolved metric objects: the per-step hot path never walks
            # the registry's name table
            self._m_steps = m.counter(
                "serving_decode_steps_total", "fused decode step dispatches")
            self._m_tokens = m.counter(
                "serving_tokens_total", "decode tokens sampled")
            self._m_step_hist = m.histogram(
                "serving_decode_step_seconds",
                "fused decode step wall (host-synced)")
            self._m_prefills = m.counter(
                "serving_prefills_total", "prompt admissions by prefill kind",
                labels=("kind",))
            self._m_prefill_hist = m.histogram(
                "serving_prefill_seconds", "submit() prefill wall")
            self._m_launches = m.gauge(
                "serving_kernel_launches_per_step",
                "kernel launches in the newest decode step (run-time count)",
                labels=("bucket",))
            self._m_grown = m.counter(
                "serving_blocks_grown_total",
                "KV blocks allocated mid-decode")
            self._m_exhausted = m.counter(
                "serving_pool_exhausted_total",
                "requests errored by KV pool exhaustion")
            self._m_pool = m.gauge(
                "serving_kv_pool", "KV block pool stats", labels=("stat",))
            m.gauge("serving_slots", "decode slots").set(n_slots)
            # the executor builds layer plans lazily at their first use, so
            # this gauge is refreshed alongside the launch gauge every step
            self._m_plans = m.gauge(
                "serving_layer_plans", "distinct layer plans in the executor")
            self._m_plans.set(self.n_layer_plans)
            self._m_plan_fallbacks = m.counter(
                "serving_plan_fallbacks_total",
                "layer-plan builds that fell back to the per-region route",
                labels=("reason",))
        else:
            self._m_steps = self._m_tokens = self._m_step_hist = None
            self._m_prefills = self._m_prefill_hist = self._m_launches = None
            self._m_grown = self._m_exhausted = self._m_pool = None
            self._m_plans = self._m_plan_fallbacks = None
        self._fb_seen: set[str] = set()  # plan keys already counted
        self._bucket = f"{n_slots}x1"  # the decode step's input bucket (BxT)

    # ------------------------------------------------------------- the mesh
    def _place(self, params) -> None:
        """Keep this rank's chunk of every parameter and decode-state leaf
        (the module docstring's rules); record the specs, the rank's slots
        and which of the reference's fallbacks the step takes."""
        mesh, cfg = self.mesh, self.cfg
        self.params = tp.shard_params(params, mesh, self.device)
        fallbacks = {}
        batch_ranks = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))
        if cfg.moe is not None:
            bspec = None
            if batch_ranks > 1:
                fallbacks["slots"] = "replicate:moe"
            if cfg.moe_manual and self.n_slots % batch_ranks:
                fallbacks["moe_manual"] = "moe_ffn"
        else:
            bspec = plan_batch_spec(mesh, self.n_slots)
            if bspec is None and batch_ranks > 1:
                fallbacks["slots"] = "replicate"
        self._bspec = bspec
        if bspec is not None:
            sl = chunk_slices((self.n_slots,), P(bspec), mesh)[0]
            self._lo, self._hi = sl.start, sl.stop
        pool = ("k", "v") if self.paged else ()  # block axis kept whole
        specs = {}
        for name, spec in decode_state_pspecs(self.state, mesh).items():
            spec = list(spec) + [None] * (self.state[name].dim() - len(spec))
            if name != "block_tbl":  # whole blocks; otherwise the slot rule
                spec[1] = None if name in pool else bspec
            specs[name] = P(*spec)
        self.state_specs = specs
        self._kv_dim = tp.kv_split(mesh, cfg.n_kv_heads, cfg.hd,
                                   self.state["k"].shape[2])
        self.state = {name: shard_leaf(v, specs[name], mesh, self.device)
                      for name, v in self.state.items()}
        self.mesh_stats = {"dims": dict(mesh.shape), "slot_axes": bspec,
                           "local_slots": (self._lo, self._hi),
                           "fallbacks": fallbacks}

    def _local_slot(self, slot: int) -> int | None:
        """``slot``'s row in this rank's slot-split leaves (None: not here)."""
        return slot - self._lo if self._lo <= slot < self._hi else None

    def _step_state(self) -> dict:
        """The decode state a step takes: the whole block table's rows of
        this rank's slots (the other leaves are stored that way)."""
        if self.mesh is None or "block_tbl" not in self.state:
            return self.state
        st = dict(self.state)
        st["block_tbl"] = st["block_tbl"][self._lo:self._hi]
        return st

    @staticmethod
    def _build_executor(artifact, device):
        """Site-keyed :class:`CompressedExecutor` over the artifact (None when
        the artifact has no routable sites)."""
        if artifact is None:
            return None
        ex = CompressedExecutor(artifact, device=device)
        return ex if ex.sites else None

    # ---------------------------------------------------------- fused step
    @torch.no_grad()
    def _fused_step(self, last_tok, pos, active, new_count, max_new, temps,
                    keys, eos: int):
        """The whole decode step — forward, sampling, bookkeeping — on the
        device; the caller makes one small device->host copy of ``packed``."""
        cfg, max_len = self.cfg, self.max_len
        # a slot emits only with cache headroom AND budget left (the
        # pre-check makes max_new <= 0 finish without sampling)
        can_emit = (pos < max_len) & (new_count < max_new)
        emit = active & can_emit
        # non-emitting slots feed position -1: attention_decode guards every
        # scatter against it, so free/finished slots never scribble on their
        # cache
        toks = torch.where(emit, last_tok, torch.zeros_like(last_tok))[:, None]
        dpos = torch.where(emit, pos - 1, torch.full_like(pos, -1))
        logits, _ = api.decode(self.params, cfg, self._step_state(), toks,
                               dpos, executor=self.executor, mesh=self.mesh)
        nxt = api.sample_tokens(logits.to(torch.float32), keys, new_count, temps)
        nxt = torch.where(emit, nxt, last_tok)
        pos2 = pos + emit
        count2 = new_count + emit
        done = emit & ((nxt == eos) | (count2 >= max_new) | (pos2 >= max_len))
        done = done | (active & ~can_emit)
        packed = torch.stack([nxt, emit.long(), done.long()])
        if self.mesh is not None and self._bspec is not None:
            packed = gather_leaf(packed, P(None, self._bspec), self.mesh)
        # carried device ctrl state: mirrors exactly the host-side updates in
        # step(), so the next step needs no H2D re-upload of it (nxt already
        # carries last_tok for non-emitting rows)
        ctrl = (nxt, pos2, active & ~done, count2)
        return packed, ctrl

    @torch.no_grad()
    def decode_logits(self, tokens, pos) -> torch.Tensor:
        """The logits ``[n_slots, V]`` of one decode step at ``tokens``
        ``[n_slots, 1]`` and positions ``pos`` ``[n_slots]`` over this
        engine's state and executor (the state is written as a step writes
        it; under a mesh the ranks' rows are gathered)."""
        mine = slice(self._lo, self._hi)
        logits, _ = api.decode(
            self.params, self.cfg, self._step_state(),
            torch.as_tensor(tokens, device=self.device)[mine],
            torch.as_tensor(pos, device=self.device)[mine],
            executor=self.executor, mesh=self.mesh)
        if self.mesh is not None and self._bspec is not None:
            logits = gather_leaf(logits, P(self._bspec), self.mesh)
        return logits

    @property
    def kernel_launches_per_step(self) -> int:
        """Kernel launches of the newest decode step, measured as the
        launch-count delta over that step (0 before the first step; excludes
        prefill, which runs dense)."""
        return self._step_launches

    @property
    def n_layer_plans(self) -> int:
        """Distinct layer plans the executor built for this engine."""
        return 0 if self.executor is None else self.executor.n_layer_plans

    # ------------------------------------------------------------------ API
    def validate_prompt(self, prompt: list[int]) -> str | None:
        """Why a prompt cannot be served (None when it can).  Single source of
        truth for ``submit()`` (raises) and the scheduler (errored result)."""
        if not prompt:
            return "empty prompt: decode needs at least one token"
        if len(prompt) > self.max_len:
            return (f"prompt of {len(prompt)} tokens exceeds the engine's "
                    f"max_len={self.max_len} KV cache")
        if (self.pool is not None and not self.pool.windowed
                and self.pool.blocks_for(len(prompt)) + 1 > self.pool.n_blocks):
            return (f"prompt of {len(prompt)} tokens can never fit the KV "
                    f"pool ({self.pool.n_blocks} blocks of "
                    f"{self.pool.block_size} tokens, one reserved for decode)")
        return None

    def can_admit(self, prompt: list[int]) -> bool:
        """Whether ``submit(prompt)`` would succeed *right now*: a free slot,
        and (paged) enough free or evictable blocks after prefix sharing.
        The scheduler's continuous-batching gate."""
        if self.active.all():
            return False
        return self.pool is None or self.pool.can_admit(prompt)

    def _sync_plan_fallbacks(self) -> None:
        """Publish newly-recorded plan fallbacks (the executor builds plans
        lazily at their first use, so this runs after every step)."""
        ex = self.executor
        if ex is None or len(ex.plan_fallbacks) == len(self._fb_seen):
            return
        for key, reason in ex.plan_fallbacks.items():
            if key not in self._fb_seen:
                self._fb_seen.add(key)
                if self._m_plan_fallbacks is not None:
                    self._m_plan_fallbacks.inc(1, reason=reason)

    def plan_stats(self) -> dict:
        """Layer-plan telemetry: plans built, measured launches per step, and
        every plan key that fell back to the per-region route with its reason."""
        self._sync_plan_fallbacks()
        fallbacks = (dict(self.executor.plan_fallbacks)
                     if self.executor is not None else {})
        out = {"n_layer_plans": self.n_layer_plans,
               "kernel_launches_per_step": self.kernel_launches_per_step,
               "fallbacks": fallbacks}
        if self.mesh is not None:
            out["mesh"] = self.mesh_stats
        return out

    def pool_stats(self) -> dict:
        """KV-pool telemetry.  Always the full key set — contiguous engines
        report every key zeroed (``n_blocks == 0`` distinguishes them).
        Mirrored into the registry's ``serving_kv_pool{stat=...}`` gauge when
        metrics are enabled."""
        s = empty_stats() if self.pool is None else self.pool.stats()
        if self._m_pool is not None:
            for k, v in s.items():
                self._m_pool.set(v, stat=k)
        return s

    def submit(self, prompt: list[int], *, max_new: int | None = None,
               temperature: float | None = None) -> int:
        """Prefill a prompt into a free slot; returns request id.

        ``max_new`` / ``temperature`` override the engine defaults for this
        request only (the per-slot budget/temp arrays feed the fused step).
        """
        err = self.validate_prompt(prompt)
        if err is not None:
            raise ValueError(err)
        free = np.where(~self.active)[0]
        if free.size == 0:
            raise RuntimeError("no free slots; call step() until one finishes")
        slot = int(free[0])
        rid = self._next_req
        self._next_req += 1
        t_pre = time.perf_counter()
        cached_tokens = 0
        # bulk only where the state is a KV sequence a forward can write
        # (the reference's rule): the recurrent families prefill token by
        # token, the hybrid's shared-block cache (``attn_k``) included
        kind = ("paged" if self.paged else "bulk" if self.bulk_prefill
                and ("k" in self.state or "c_kv" in self.state)
                else "tokenwise")
        if self.paged:
            plan = self.pool.admit(slot, prompt)
            if plan is None:
                self._next_req -= 1
                raise RuntimeError(
                    f"insufficient free KV blocks for a {len(prompt)}-token "
                    f"prompt ({self.pool.available_blocks} available); step() "
                    "until a request finishes")
            self._prefill_slot_paged(slot, prompt, plan)
            self.pool.register_prefix(slot, prompt)
            cached_tokens = plan.cached_tokens
        elif kind == "bulk":
            # one bulk forward writes the whole slot cache (and rewrites the
            # full kpos row, so stale entries need no separate reset)
            self._prefill_slot(slot, prompt)
        else:
            # the slot column is reset first so the previous occupant's
            # cache entries, kpos and recurrent state never leak
            self._reset_slot_state(slot)
            self._prefill_slot_tokenwise(slot, prompt)
        self.pos[slot] = len(prompt)
        self.active[slot] = True
        self._last_tok[slot] = prompt[-1]
        self._new_count[slot] = 0
        self._max_new_arr[slot] = self.max_new if max_new is None else max_new
        self._temp_arr[slot] = self.temp if temperature is None else temperature
        # request-keyed sampling: draws depend on (seed, rid, token count),
        # never on which slot the request landed in or what else is in flight
        self._keys[slot] = api.request_key(self.seed, rid)
        self._ctrl_dev = None  # budget/temp/key arrays changed: re-upload once
        self._slot_dev = None  # host mirrors mutated: re-upload once
        self.slot_req[slot] = rid
        # host wall of the whole admission (dispatch + bookkeeping; the
        # device work may still be in flight)
        prefill_s = time.perf_counter() - t_pre
        if self._m_prefills is not None:
            self._m_prefills.inc(1, kind=kind)
            self._m_prefill_hist.observe(prefill_s)
        self.results[rid] = GenerationResult(
            tokens=list(prompt), prompt_len=len(prompt), finished=False,
            stats={"prefill_s": prefill_s, "prefill_kind": kind,
                   "cached_tokens": cached_tokens})
        return rid

    # -------------------------------------------------------------- prefill
    @torch.no_grad()
    def _reset_slot_state(self, slot: int) -> None:
        """Clear one slot's column of every decode-state leaf, in place
        (``kpos``/``attn_kpos``/``self_kpos`` to -1; caches, ``wkv``/
        ``x_prev_*`` and ``ssm``/``conv`` to 0) so a reused slot never sees
        its previous occupant's KV entries or recurrent state.  Whisper's
        cross-KV (``cross_*``) is kept: the caller sets it per slot, as in
        the reference."""
        for name, v in self.state.items():
            if not name.startswith("cross_"):
                v[:, slot] = -1 if "kpos" in name else 0

    @torch.no_grad()
    def _merge_slot_state(self, old, new, slot: int) -> None:
        """Copy ``new``'s batch column ``slot`` into ``old``, in place — the
        tokenwise prefill must not touch other slots' cache or advance their
        recurrent state."""
        for name, v in old.items():
            if new[name] is not v:  # a shared leaf (the cross-KV) is both
                v[:, slot] = new[name][:, slot]

    @torch.no_grad()
    def _prefill_slot_tokenwise(self, slot: int, prompt: list[int]) -> None:
        """Tokenwise prefill: one decode step per prompt token, through the
        engine's executor as a decode step goes (the recurrent families'
        prefill, and the bulk path's equivalence and latency baseline).  Decode rows are independent, so
        the loop runs on a scratch copy of the state (the other slots feed
        token 0 at their last position, as in the reference) and only the
        target slot's column is merged back.  A decode step never writes
        whisper's static cross-KV, so the scratch shares it."""
        scratch = {k: v if k.startswith("cross_") else v.clone()
                   for k, v in self.state.items()}
        for t, tok in enumerate(prompt):
            _logits, scratch = api.decode(
                self.params, self.cfg, scratch, self._token_batch(slot, tok),
                self._pos_batch(slot, t), executor=self.executor)
        self._merge_slot_state(self.state, scratch, slot)

    def _token_batch(self, slot: int, tok: int) -> torch.Tensor:
        t = torch.zeros((self.n_slots, 1), dtype=torch.long)
        t[slot, 0] = tok
        return t.to(self.device)

    def _pos_batch(self, slot: int, pos: int) -> torch.Tensor:
        p = np.asarray(self.pos - 1, np.int64).clip(0)
        p[slot] = pos
        return torch.from_numpy(p).to(self.device)

    @torch.no_grad()
    def _prefill_caches(self, prompt: list[int]):
        """ONE ``api.prefill`` forward over the prompt -> (k, v) caches
        ``[L, 1, S, Hkv, hd]`` (MLA: (c_kv, k_rope) ``[L, 1, S, ...]``).  Eager execution needs no length buckets, so
        the prompt is not padded."""
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        _h, caches = api.prefill(self.params, self.cfg, {"tokens": toks},
                                 collect_cache=True, mesh=self.mesh)
        return caches

    def _kv_local(self, vals: torch.Tensor) -> torch.Tensor:
        """This rank's slice of whole K/V values (all of them unmeshed)."""
        if self.mesh is None:
            return vals
        return tp.kv_local(vals, self.mesh, self._kv_dim)

    @torch.no_grad()
    def _prefill_slot(self, slot: int, prompt: list[int]) -> None:
        """Bulk prefill into the contiguous cache: write the slot's K/V (MLA:
        its latents) at its positions (ring positions when windowed) and its
        whole ``kpos`` row."""
        plen = len(prompt)
        caches = self._prefill_caches(prompt)
        st = self.state
        eff = st["kpos"].shape[2]  # ring size when windowed, else max_len
        ps = np.arange(max(0, plen - eff), plen)
        slots = ps % eff if self.cfg.attn_window is not None else ps
        kpos_row = np.full(eff, -1, np.int32)
        kpos_row[slots] = ps
        ps_d = torch.from_numpy(ps).to(self.device)
        slots_d = torch.from_numpy(slots).to(self.device)
        row = self._local_slot(slot)
        if row is None:  # another rank's slot: it computed, it writes
            return
        for name, c_all in zip(self._cache_leaves, caches):
            st[name][:, row, slots_d] = self._kv_local(
                c_all[:, 0, ps_d]).to(st[name].dtype)
        st["kpos"][:, row] = torch.from_numpy(kpos_row).to(self.device)

    # --------------------------------------------------------- paged prefill
    def _scatter_pool(self, name: str, tbl_row: np.ndarray, vidx: np.ndarray,
                      vals: torch.Tensor) -> None:
        """Write per-token values ``vals`` [L, n, ...] into the pool leaf
        ``name`` at the slot's logical view indices ``vidx`` (block =
        table[v // bs], offset v % bs)."""
        bs = self.pool.block_size
        blocks = torch.from_numpy(tbl_row[vidx // bs].astype(np.int64)).to(self.device)
        offs = torch.from_numpy((vidx % bs).astype(np.int64)).to(self.device)
        leaf = self.state[name]
        leaf[:, blocks, offs] = self._kv_local(vals).to(leaf.dtype)

    @torch.no_grad()
    def _prefill_slot_paged(self, slot: int, prompt: list[int], plan) -> None:
        """Apply an :class:`~repro_torch.serving.kvpool.AdmitPlan`: install the
        block table row, device-copy the COW block, prefill only the
        non-cached tail (one bulk forward when cold, ``api.prefill_extend``
        against the gathered resident prefix on a prefix hit), and scatter
        the fresh K/V (MLA: latents) into the slot's blocks."""
        st = self.state
        cfg, pool = self.cfg, self.pool
        bs, plen = pool.block_size, len(prompt)
        view = pool.view_blocks * bs  # == ring size when windowed
        tbl_row = plan.table
        self._tbl_host[slot] = tbl_row
        st["block_tbl"].copy_(torch.from_numpy(self._tbl_host))
        if plan.cow is not None:
            src, dst = plan.cow
            for name in self._cache_leaves:
                st[name][:, dst] = st[name][:, src]
        cached = plan.cached_tokens
        kpos_row = np.full(view, -1, np.int32)
        if cfg.attn_window is not None:  # ring layout, no prefix sharing
            ps = np.arange(max(0, plen - view), plen)
            vidx = ps % view
            kpos_row[vidx] = ps
        else:
            ps = np.arange(cached, plen)
            vidx = ps
            kpos_row[:plen] = np.arange(plen)
        if ps.size:  # uncached tail to prefill (cached == plen: nothing —
            # the first decode step recomputes the last token's K/V anyway)
            if cached == 0:
                caches = self._prefill_caches(prompt)
                ps_d = torch.from_numpy(ps).to(self.device)
                for name, c_all in zip(self._cache_leaves, caches):
                    self._scatter_pool(name, tbl_row, vidx, c_all[:, 0, ps_d])
            else:
                self._extend_tail(prompt, cached, tbl_row, vidx, view)
        row = self._local_slot(slot)
        if row is not None:
            st["kpos"][:, row] = torch.from_numpy(kpos_row).to(self.device)

    @torch.no_grad()
    def _extend_tail(self, prompt: list[int], cached: int, tbl_row: np.ndarray,
                     vidx: np.ndarray, view: int) -> None:
        """Prefix-hit tail prefill: gather the resident prefix through the
        block table (the exact contiguous view), run the tail tokens against
        it in one forward, scatter the tail K/V back.  The tail is padded to
        the reference's bucket ``max(8, next power of two)`` at position -1:
        an MoE block routes the padded rows too, so the same bucket keeps
        the same expert capacity and drops."""
        cfg, dev, plen = self.cfg, self.device, len(prompt)
        tl = plen - cached
        t_pad = max(8, 1 << (tl - 1).bit_length())
        toks = torch.zeros((1, t_pad), dtype=torch.long)
        toks[0, :tl] = torch.tensor(prompt[cached:])
        posn = torch.full((1, t_pad), -1, dtype=torch.long)
        posn[0, :tl] = torch.arange(cached, plen)
        tbl = torch.from_numpy(tbl_row.astype(np.int64)).to(dev)
        past = {}
        for name in self._cache_leaves:
            pool_leaf = self.state[name]  # [L, Nb, bs, ...]
            past[name] = pool_leaf[:, tbl].reshape(
                pool_leaf.shape[0], 1, view, *pool_leaf.shape[3:])
            if self.mesh is not None:  # this rank's slice -> whole
                past[name] = tp.gather_kv(past[name], self.mesh, self._kv_dim)
        pk = torch.full((1, view), -1, dtype=torch.int32)
        pk[0, :cached] = torch.arange(cached)
        past["kpos"] = pk.to(dev)[None].expand(cfg.n_layers, 1, view)
        _logits, tails = api.prefill_extend(
            self.params, cfg, toks.to(dev), posn.to(dev), past,
            torch.tensor([tl - 1], device=dev), mesh=self.mesh)
        for name, tail in tails.items():  # [L, 1, t_pad, ...]
            self._scatter_pool(name, tbl_row, vidx, tail[:, 0, :tl])

    def _release_slot(self, slot: int) -> None:
        """Return a retired slot's blocks to the pool (registered prefix
        blocks stay cached) and clear its table row."""
        self.pool.release(slot)
        self._tbl_host[slot] = 0
        self.state["block_tbl"].copy_(torch.from_numpy(self._tbl_host))

    def cancel(self, rid: int) -> bool:
        """Stop an in-flight request (its slot frees on the spot); returns
        whether anything was cancelled.  The result keeps the tokens sampled
        so far and is marked finished."""
        for slot, r in self.slot_req.items():
            if r == rid and self.active[slot]:
                self.active[slot] = False
                self._slot_dev = None  # host mirrors mutated: re-upload once
                if self.paged:
                    self._release_slot(slot)
                self.results[rid].finished = True
                self.results[rid].stats["cancelled"] = True
                return True
        return False

    def step(self) -> list[StepEvent]:
        """One fused decode step for every active slot; the only
        device->host traffic is the packed [3, n_slots] (token, emit, done)
        tensor.  Returns this step's per-slot events."""
        events: list[StepEvent] = []
        if not self.active.any():
            return events
        if self.paged:
            events.extend(self._grow_blocks())
            if not self.active.any():
                return events
        dev = self.device
        eos = -1 if self.eos is None else int(self.eos)
        mine = slice(self._lo, self._hi)  # this rank's slots (all unmeshed)
        if self._ctrl_dev is None:  # max_new/temps/keys only change at submit
            self._ctrl_dev = tuple(
                torch.from_numpy(a[mine]).to(dev)
                for a in (self._max_new_arr, self._temp_arr, self._keys))
        if self._slot_dev is None:  # first step after a host-side mutation
            self._slot_dev = tuple(
                torch.from_numpy(a[mine]).to(dev)
                for a in (self._last_tok, self.pos, self.active,
                          self._new_count))
        t0 = self.profiler.begin() if self.profiler is not None else 0.0
        n0 = dispatch.launch_count()
        packed, self._slot_dev = self._fused_step(*self._slot_dev,
                                                  *self._ctrl_dev, eos)
        self._step_launches = dispatch.launch_count() - n0
        self.step_dispatches += 1
        nxt, emit, done = packed.cpu().numpy()  # the one small host transfer
        if self.profiler is not None:
            # the .cpu() copy above already synced the step, so no fence needed
            n_emit = int(emit.sum())
            dt = self.profiler.end(t0, tokens=n_emit)
            self._m_steps.inc()
            self._m_tokens.inc(n_emit)
            self._m_step_hist.observe(dt)
            self._m_launches.set(self._step_launches, bucket=self._bucket)
            self._m_plans.set(self.n_layer_plans)
        self._sync_plan_fallbacks()
        for slot in np.where(self.active)[0]:
            rid = self.slot_req[slot]
            r = self.results[rid]
            tok: int | None = None
            if emit[slot]:
                tok = int(nxt[slot])
                r.tokens.append(tok)
                self._last_tok[slot] = tok
                self.pos[slot] += 1
                self._new_count[slot] += 1
            if done[slot]:
                r.finished = True
                self.active[slot] = False
                if self.paged:
                    self._release_slot(slot)
            events.append(StepEvent(rid=rid, token=tok, finished=bool(done[slot])))
        return events

    def _grow_blocks(self) -> list[StepEvent]:
        """Pre-step block growth: the upcoming step writes each active slot's
        K/V at view index ``pos - 1`` — allocate the covering block when the
        table has none (0 = null).  Windowed slots preallocate their whole
        ring at admit, so this is a no-op for them.  A slot the pool cannot
        grow finishes with an error (its blocks return to the pool)."""
        events: list[StepEvent] = []
        bs = self.pool.block_size
        view = self.pool.view_blocks * bs
        dirty = False
        for slot in np.where(self.active)[0]:
            bi = (int(self.pos[slot]) - 1) % view // bs
            if self._tbl_host[slot, bi] != 0:
                continue
            bid = self.pool.append_block(slot)
            if bid is None:
                rid = self.slot_req[slot]
                r = self.results[rid]
                r.finished = True
                r.error = ("KV block pool exhausted mid-decode "
                           f"({self.pool.in_use_blocks} blocks in use)")
                r.stats["exhausted"] = True
                if self._m_exhausted is not None:
                    self._m_exhausted.inc()
                self.active[slot] = False
                self._slot_dev = None
                self._release_slot(slot)
                events.append(StepEvent(rid=rid, token=None, finished=True))
                continue
            self._tbl_host[slot, bi] = bid
            r = self.results[self.slot_req[slot]]
            r.stats["blocks_grown"] = r.stats.get("blocks_grown", 0) + 1
            if self._m_grown is not None:
                self._m_grown.inc()
            dirty = True
        if dirty:
            self.state["block_tbl"].copy_(torch.from_numpy(self._tbl_host))
        return events

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32, *,
                 temperature: float | None = None, on_token=None
                 ) -> list[GenerationResult]:
        """Continuous-batched generation over a request list (Scheduler-driven).

        Invalid prompts (empty / beyond the KV cache) do not abort the batch:
        they come back as ``GenerationResult(finished=True, error=...)`` while
        the rest of the batch completes.  ``on_token(rid, token)`` streams
        tokens as they are sampled.
        """
        from .scheduler import Scheduler

        sched = Scheduler(self)
        rids = [sched.enqueue(p, max_new=max_new_tokens, temperature=temperature,
                              on_token=on_token) for p in prompts]
        sched.run()
        return [sched.take_result(r) for r in rids]


_MESH_REFUSED = "ROADMAP A7c: the reference partitions it through GSPMD"


def _mesh_device(mesh, cfg, bulk_prefill: bool, device) -> torch.device:
    """The device a meshed engine lives on (the mesh's: a card under NCCL,
    the CPU under gloo), after refusing what ``mesh=`` does not serve."""
    import torch.distributed as dist

    family = api.family_of(cfg)
    if cfg.mla is not None:
        what = "MLA attention"
    elif family in ("vlm", "ssm", "hybrid", "audio") or cfg.enc_layers > 0:
        what = f"the {family} family"
    elif not bulk_prefill:
        what = "the tokenwise prefill"
    else:
        what = None
    if what is not None:
        raise NotImplementedError(f"mesh=: {what} is not served over a mesh "
                                  f"in this package yet ({_MESH_REFUSED})")
    if not dist.is_initialized():
        raise RuntimeError("mesh=: the process group is not up (join() or "
                           "run_ranks before building the mesh)")
    if not mesh.member:
        raise ValueError("mesh=: this rank is outside the mesh")
    if "model" not in mesh.shape:
        raise ValueError("mesh=: the policy places parameters over a "
                         "'model' axis; give the mesh one (of size 1 for no "
                         "tensor parallelism)")
    if device.type != mesh.device.type:
        raise ValueError(f"mesh=: the mesh's ranks live on "
                         f"{mesh.device.type}, the engine was given {device}")
    return mesh.device
