"""Request scheduler over :class:`~repro_torch.serving.engine.ServingEngine`.

The engine owns slots and the fused device step; the scheduler owns the
request lifecycle:

* a priority queue (higher ``priority`` first, FIFO within a priority),
* admission control — a request enters a slot only when one is free AND its
  prompt fits the per-slot KV budget (``max_len``); requests whose prompt +
  budget exceed the cache are still admitted and simply capped at ``max_len``,
* per-request ``max_new`` / ``temperature`` overrides (forwarded to the
  engine's per-slot budget arrays inside the fused step),
* streaming: ``on_token(rid, token)`` fires for every token sampled by this
  scheduler's ``step()``/``run()`` (steps driven directly on the engine
  bypass it — their tokens land only in the request's result),
* failed-request isolation — a prompt that fails validation (empty, beyond
  the KV cache) or whose submission raises becomes a finished
  ``GenerationResult(error=...)``; the rest of the batch is unaffected.

Both ``ServingEngine.generate()`` and ``repro_torch.launch.serve`` drive their
batches through this class.  With the engine's tracer (``tracer=True``) every
request gets a span (:mod:`repro_torch.obs.trace`), and with its registry
the continuous-batching counters and queue gauges are published there.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable

from .engine import GenerationResult, ServingEngine, StepEvent

__all__ = ["Request", "Scheduler"]


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int | None = None
    temperature: float | None = None
    priority: int = 0
    on_token: Callable[[int, int], None] | None = field(default=None, repr=False)
    sid: int | None = None  # tracer span id (tracer namespace, not rid)
    # aliased engine result: survives the engine-side eviction at retire
    result: GenerationResult | None = field(default=None, repr=False)


class Scheduler:
    """Queue + admission + streaming over one engine.  Request ids issued by
    the scheduler are its own namespace (``results`` is keyed by them); the
    engine's internal ids never surface."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self._heap: list[tuple[int, int, Request]] = []
        self._seq = 0  # FIFO tiebreak within a priority class
        self._next_rid = 0
        self.results: dict[int, GenerationResult] = {}
        self._inflight: dict[int, Request] = {}  # engine rid -> request
        # continuous-batching telemetry (ints kept for direct access; the
        # engine's registry mirrors them as counters when metrics are on)
        self.admitted_while_running = 0  # admissions joining a live batch
        self.mem_stalls = 0  # admit() passes blocked on KV blocks, not slots
        m = engine.metrics
        if m is not None:
            self._m_admit_run = m.counter(
                "sched_admitted_while_running_total",
                "admissions that joined a live batch (continuous batching)")
            self._m_stalls = m.counter(
                "sched_mem_stalls_total",
                "admission passes blocked on KV blocks, not slots")
            self._m_pending = m.gauge("sched_pending", "queued requests")
            self._m_inflight = m.gauge("sched_inflight", "in-flight requests")
        else:
            self._m_admit_run = self._m_stalls = None
            self._m_pending = self._m_inflight = None

    @property
    def tracer(self):
        """The engine's tracer, read live (it may be attached after this
        scheduler was built)."""
        return self.engine.tracer

    # ---------------------------------------------------------------- queue
    def enqueue(self, prompt: list[int], *, max_new: int | None = None,
                temperature: float | None = None, priority: int = 0,
                on_token: Callable[[int, int], None] | None = None) -> int:
        """Queue a request; returns its scheduler id immediately.  Invalid
        prompts resolve to an errored, finished result instead of raising."""
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=list(prompt), max_new=max_new,
                      temperature=temperature, priority=priority,
                      on_token=on_token)
        tr = self.tracer
        if tr is not None:
            req.sid = tr.enqueue(rid, len(req.prompt))
        err = self.engine.validate_prompt(req.prompt)
        if err is not None:
            self.results[rid] = GenerationResult(
                tokens=list(req.prompt), prompt_len=len(req.prompt),
                finished=True, error=err)
            if req.sid is not None:
                tr.retire(req.sid, status="error", error=err)
            return rid
        heapq.heappush(self._heap, (-priority, self._seq, req))
        self._seq += 1
        return rid

    def take_result(self, rid: int) -> GenerationResult:
        """Pop a request's result (raises KeyError if unknown).  Long-running
        serve loops should collect through this so memory stays bounded by
        in-flight + uncollected work, not by total requests ever served."""
        return self.results.pop(rid)

    @property
    def pending(self) -> int:
        return len(self._heap)

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    # ------------------------------------------------------------ admission
    def admit(self) -> list[int]:
        """Move queued requests into free engine slots (priority order);
        returns the scheduler ids admitted now.

        Continuous batching: this runs between decode steps, so requests join
        a live batch the moment a slot frees — the batch never drains.  On a
        paged engine admission is additionally gated on KV *blocks*
        (``engine.can_admit``): when the head-of-queue prompt cannot get its
        blocks, admission stops — strictly, so a big high-priority request is
        never starved by small ones slipping past it (no head-of-line
        bypass)."""
        admitted: list[int] = []
        tr = self.tracer
        while self._heap and (~self.engine.active).any():
            req = self._heap[0][2]
            if not self.engine.can_admit(req.prompt):
                self.mem_stalls += 1
                if self._m_stalls is not None:
                    self._m_stalls.inc()
                break
            heapq.heappop(self._heap)
            was_running = bool(self.engine.active.any())
            try:
                erid = self.engine.submit(req.prompt, max_new=req.max_new,
                                          temperature=req.temperature)
            except Exception as e:  # isolation: one bad request never
                self.results[req.rid] = GenerationResult(  # strands the batch
                    tokens=list(req.prompt), prompt_len=len(req.prompt),
                    finished=True, error=str(e))
                if tr is not None and req.sid is not None:
                    tr.retire(req.sid, status="error", error=str(e))
                continue
            # alias the engine's live result object: token appends and the
            # finished flag propagate without copying
            req.result = self.engine.results[erid]
            self.results[req.rid] = req.result
            self._inflight[erid] = req
            admitted.append(req.rid)
            self.admitted_while_running += was_running
            if tr is not None and req.sid is not None:
                tr.admit(req.sid)
            if was_running and self._m_admit_run is not None:
                self._m_admit_run.inc()
        return admitted

    # ---------------------------------------------------------------- drive
    def step(self) -> list[StepEvent]:
        """Admit what fits, run one fused engine step, fire callbacks.
        Returns the step's events re-keyed to *scheduler* request ids (events
        for slots submitted outside this scheduler are omitted — the engine
        id namespace never surfaces here)."""
        self.admit()
        events = self.engine.step()
        tr = self.tracer
        out: list[StepEvent] = []
        for ev in events:
            req = self._inflight.get(ev.rid)
            if req is None:
                continue  # slot submitted outside this scheduler
            out.append(StepEvent(rid=req.rid, token=ev.token,
                                 finished=ev.finished))
            if ev.token is not None and tr is not None and req.sid is not None:
                tr.token(req.sid)
            if ev.token is not None and req.on_token is not None:
                try:
                    req.on_token(req.rid, ev.token)
                except Exception as e:  # isolation: a broken streaming
                    # consumer cancels only its own request, not the batch —
                    # and only if generation is still running; a delivery
                    # failure on the final token leaves the completed result
                    if not ev.finished:
                        # guarded lookup: the caller may have collected the
                        # in-flight result via take_result() already
                        res = self.results.get(req.rid,
                                               self.engine.results.get(ev.rid))
                        if res is not None:
                            res.error = f"streaming callback failed: {e!r}"
                        self.engine.cancel(ev.rid)
                        # consumers keying teardown off StepEvent.finished
                        # still get a terminal event for the cancelled request
                        out.append(StepEvent(rid=req.rid, token=None,
                                             finished=True))
        # retire via the aliased result, not the event stream: a request whose
        # finishing step ran outside this scheduler (direct engine.step(), an
        # interleaved generate()) must still unblock run().  The engine-side
        # entry is evicted here; the scheduler's own ``results`` keeps the
        # finished result until the caller collects it via take_result().
        for erid in [e for e, rq in self._inflight.items()
                     if self.engine.results.get(e) is None
                     or rq.result.finished]:
            req = self._inflight.pop(erid)
            self.engine.results.pop(erid, None)
            if tr is not None and req.sid is not None:
                r = req.result
                tr.annotate(req.sid, **r.stats)
                if r.stats.get("cancelled"):
                    tr.retire(req.sid, status="cancelled", error=r.error)
                elif r.error is not None:
                    tr.retire(req.sid, status="error", error=r.error)
                else:
                    tr.retire(req.sid, status="ok")
        if self._m_pending is not None:
            self._m_pending.set(len(self._heap))
            self._m_inflight.set(len(self._inflight))
        return out

    def run(self) -> dict[int, GenerationResult]:
        """Drive until the queue and all in-flight slots drain."""
        while self._heap or self._inflight or self.engine.active.any():
            self.step()
        return self.results
