"""Per-request span tracing for the serving stack (counterpart of
``repro.obs.trace``: the same spans, summary and JSONL).

A :class:`Span` follows one request through its whole lifecycle::

    enqueue -> admit -> (prefill meta) -> token ... token -> retire
       |         |                          |                  |
    queue wait   +-- TTFT ------------------+    time/output-token (TPOT)

The scheduler drives the lifecycle (it owns the request namespace); the
engine contributes per-request facts — prefill wall, prefix-cache hit tokens,
decode-time block growth — through ``GenerationResult.stats``, which the
scheduler folds into the span's ``meta`` at retire.  Every ``mark_every``-th
token the span records a decode mark ``(n_tokens, t)``, so a long generation
shows its pacing, not just its endpoints.

Span ids are tracer-allocated (monotonic) rather than request ids: request id
namespaces restart per scheduler, and one engine may serve several scheduler
generations (``generate()`` builds a fresh one per call).

``dump_jsonl`` writes one JSON object per span — completed spans first, then
any still-open ones (``status == "open"``), so "zero unclosed spans" is a
grep away for CI.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

__all__ = ["Span", "RequestTracer"]

_TERMINAL = ("ok", "error", "cancelled")


def _pct(sorted_vals: list[float], q: float) -> float | None:
    """Nearest-rank percentile over an ascending list (stdlib-only)."""
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(i)]


@dataclass
class Span:
    sid: int
    rid: int
    prompt_len: int
    enqueue_t: float
    admit_t: float | None = None
    first_token_t: float | None = None
    last_token_t: float | None = None
    retire_t: float | None = None
    n_tokens: int = 0
    status: str = "open"
    error: str | None = None
    marks: list = field(default_factory=list)  # [(n_tokens, t_abs), ...]
    meta: dict = field(default_factory=dict)

    # ------------------------------------------------------------- derived
    @property
    def queue_wait_s(self) -> float | None:
        return None if self.admit_t is None else self.admit_t - self.enqueue_t

    @property
    def ttft_s(self) -> float | None:
        """Time to first token, measured from arrival (enqueue)."""
        return (None if self.first_token_t is None
                else self.first_token_t - self.enqueue_t)

    @property
    def tpot_s(self) -> float | None:
        """Mean time per output token after the first."""
        if self.first_token_t is None or self.n_tokens < 2:
            return None
        return (self.last_token_t - self.first_token_t) / (self.n_tokens - 1)

    @property
    def e2e_s(self) -> float | None:
        return None if self.retire_t is None else self.retire_t - self.enqueue_t

    def to_dict(self) -> dict:
        t0 = self.enqueue_t
        d = {"sid": self.sid, "rid": self.rid, "prompt_len": self.prompt_len,
             "status": self.status, "error": self.error,
             "n_tokens": self.n_tokens,
             "queue_wait_s": self.queue_wait_s, "ttft_s": self.ttft_s,
             "tpot_s": self.tpot_s, "e2e_s": self.e2e_s,
             "marks": [{"tokens": n, "t_s": t - t0} for n, t in self.marks]}
        d.update(self.meta)
        return d


class RequestTracer:
    """Span factory + sink.  Pass ``metrics=`` (a
    :class:`~repro_torch.obs.metrics.MetricsRegistry`) to additionally publish
    TTFT / TPOT / queue-wait histograms and per-status request counters as
    spans retire; ``clock=`` is injectable for deterministic tests."""

    def __init__(self, *, mark_every: int = 8, metrics=None,
                 clock=time.perf_counter):
        self.mark_every = max(1, int(mark_every))
        self.clock = clock
        self._lock = threading.RLock()
        self._next_sid = 0
        self._open: dict[int, Span] = {}
        self.completed: list[Span] = []
        self._m = None
        if metrics is not None:
            self._m = {
                "ttft": metrics.histogram(
                    "serving_ttft_seconds", "time to first token (arrival)"),
                "tpot": metrics.histogram(
                    "serving_tpot_seconds", "time per output token"),
                "queue": metrics.histogram(
                    "serving_queue_wait_seconds", "enqueue -> admit wait"),
                "requests": metrics.counter(
                    "serving_requests_total", "retired requests by status",
                    labels=("status",)),
            }

    # -------------------------------------------------------------- lifecycle
    def enqueue(self, rid: int, prompt_len: int) -> int:
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            self._open[sid] = Span(sid=sid, rid=rid, prompt_len=prompt_len,
                                   enqueue_t=self.clock())
        return sid

    def admit(self, sid: int) -> None:
        s = self._open.get(sid)
        if s is not None and s.admit_t is None:
            s.admit_t = self.clock()

    def token(self, sid: int) -> None:
        s = self._open.get(sid)
        if s is None:
            return
        t = self.clock()
        if s.first_token_t is None:
            s.first_token_t = t
        s.last_token_t = t
        s.n_tokens += 1
        if s.n_tokens % self.mark_every == 0:
            s.marks.append((s.n_tokens, t))

    def annotate(self, sid: int, **meta) -> None:
        s = self._open.get(sid)
        if s is not None:
            s.meta.update(meta)

    def retire(self, sid: int, status: str = "ok",
               error: str | None = None) -> Span | None:
        """Close a span exactly once (a second retire is a no-op, so a
        cancel racing a natural finish cannot double-count)."""
        if status not in _TERMINAL:
            raise ValueError(f"retire status {status!r} not in {_TERMINAL}")
        with self._lock:
            s = self._open.pop(sid, None)
            if s is None:
                return None
            s.retire_t = self.clock()
            s.status = status
            s.error = error
            self.completed.append(s)
        if self._m is not None:
            self._m["requests"].inc(1, status=status)
            if s.queue_wait_s is not None:
                self._m["queue"].observe(s.queue_wait_s)
            if s.ttft_s is not None:
                self._m["ttft"].observe(s.ttft_s)
            if s.tpot_s is not None:
                self._m["tpot"].observe(s.tpot_s)
        return s

    # ---------------------------------------------------------------- queries
    @property
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def spans(self, status: str | None = None) -> list[Span]:
        with self._lock:
            spans = list(self.completed)
            if status is None or status == "open":
                spans += list(self._open.values())
        if status is not None:
            spans = [s for s in spans if s.status == status]
        return spans

    def summary(self) -> dict:
        """Aggregate percentiles over completed spans (seconds)."""
        with self._lock:
            done = list(self.completed)
            n_open = len(self._open)
        by_status: dict[str, int] = {}
        for s in done:
            by_status[s.status] = by_status.get(s.status, 0) + 1

        def stats(vals):
            vals = sorted(v for v in vals if v is not None)
            return {"p50": _pct(vals, 0.50), "p99": _pct(vals, 0.99),
                    "n": len(vals)}

        return {
            "completed": len(done), "open": n_open, "by_status": by_status,
            "queue_wait_s": stats(s.queue_wait_s for s in done),
            "ttft_s": stats(s.ttft_s for s in done),
            "tpot_s": stats(s.tpot_s for s in done),
            "e2e_s": stats(s.e2e_s for s in done),
            "tokens": sum(s.n_tokens for s in done),
        }

    def dump_jsonl(self, path: str) -> int:
        """Write every span (completed, then open) as JSONL; returns the
        number of still-open spans so callers can assert on leaks."""
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict(), default=str) + "\n")
        return sum(s.status == "open" for s in spans)
