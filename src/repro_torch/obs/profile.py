"""Step profiling and the live roofline (counterpart of
``repro.obs.profile``).

:class:`StepProfiler` is a bounded wall-time ring buffer for the engine's
fused decode step.  Host wall-clock alone under-reports async dispatch, so
every ``fence_every``-th sample the profiler synchronizes the device of
the value the caller hands it (``torch.cuda.synchronize``) *before* reading
the clock — those samples carry the true device latency while the rest stay
free.  (The serving engine already syncs each step when it copies the
sampled tokens to the host, so every sample is honest there; the fencing
matters for callers that keep steps in flight.)

:func:`roofline` is the pure function behind the reference's
``BENCH_serving.json`` roofline section: per-site shift-add budget from an
artifact's :class:`~repro_torch.core.cost.ModelCostReport` joined with a
measured decode throughput into achieved adds/s.  :func:`live_roofline`
feeds it from a *running* engine — artifact from the executor, tok/s from
the engine's own profiler, launches from the engine's newest step.  The
one key the reference names after Pallas, ``pallas_launches``, is
``kernel_launches`` here.
"""
from __future__ import annotations

import time
from collections import deque

__all__ = ["StepProfiler", "roofline", "live_roofline"]


def _pct(sorted_vals, q: float) -> float | None:
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(i)]


def _fence(value) -> None:
    """Wait for the device work behind ``value``: a tensor, or a list,
    tuple or dict of them.  CUDA tensors synchronize their device (once a
    device; a CUDA error raises); host values need no wait."""
    import torch

    devices = set()
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, torch.Tensor) and v.is_cuda:
            devices.add(v.device)
    for d in devices:
        torch.cuda.synchronize(d)


class StepProfiler:
    """Ring buffer of per-step wall times with periodic device fencing.

    Usage (the engine's step loop)::

        t0 = prof.begin()
        out = step_fn(...)
        prof.end(t0, tokens=n_active, fence=out)

    ``fence`` is only synced on every ``fence_every``-th sample; pass
    ``fence=None`` to never sync (pure host timing).
    """

    def __init__(self, capacity: int = 4096, fence_every: int = 32,
                 clock=time.perf_counter):
        self.capacity = int(capacity)
        self.fence_every = max(0, int(fence_every))
        self.clock = clock
        self._ring: deque = deque(maxlen=self.capacity)  # (wall_s, tokens, fenced)
        self._n = 0          # lifetime samples (ring may have dropped old ones)
        self._fenced = 0

    def begin(self) -> float:
        return self.clock()

    def end(self, t0: float, tokens: int = 0, fence=None) -> float:
        self._n += 1
        fenced = (fence is not None and self.fence_every
                  and self._n % self.fence_every == 0)
        if fenced:
            _fence(fence)
            self._fenced += 1
        dt = self.clock() - t0
        self._ring.append((dt, int(tokens), fenced))
        return dt

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def total_steps(self) -> int:
        return self._n

    def summary(self) -> dict:
        """Aggregates over the samples currently in the ring."""
        samples = list(self._ring)
        if not samples:
            return {"steps": 0, "total_steps": self._n, "fenced": self._fenced,
                    "tok_s": None, "mean_ms": None, "p50_ms": None,
                    "p99_ms": None}
        walls = sorted(s[0] for s in samples)
        total_wall = sum(walls)
        total_tok = sum(s[1] for s in samples)
        return {
            "steps": len(samples),
            "total_steps": self._n,
            "fenced": self._fenced,
            "tok_s": (total_tok / total_wall) if total_wall > 0 else None,
            "mean_ms": total_wall / len(walls) * 1e3,
            "p50_ms": _pct(walls, 0.50) * 1e3,
            "p99_ms": _pct(walls, 0.99) * 1e3,
        }


def roofline(artifact, decode_tok_s, *, kernel_launches=None,
             n_layer_plans=None, mode: str | None = None,
             arch: str | None = None) -> dict:
    """Per-site shift-add budget x measured throughput -> achieved adds/s.

    Same shape as the ``roofline`` sections in ``BENCH_serving.json``, so
    live-engine output and offline-bench output diff cleanly.
    """
    rep = artifact.report
    total_lcc = rep.total_stage("lcc")
    tok_s = None if decode_tok_s is None else float(decode_tok_s)
    sec = {
        "mode": mode, "arch": arch,
        "total_baseline_adds": rep.total_baseline(),
        "total_lcc_adds": total_lcc,
        "decode_tok_s_n8": round(tok_s, 2) if tok_s is not None else None,
        "kernel_launches": kernel_launches,
        "n_layer_plans": n_layer_plans,
        "achieved_adds_per_s": (round(tok_s * total_lcc)
                                if tok_s is not None else None),
        "sites": [{"site": l.name, "baseline_adds": l.baseline_adds,
                   "lcc_adds": l.stage_adds.get("lcc"),
                   "ratio": (round(l.ratio("lcc"), 2)
                             if l.stage_adds.get("lcc") else None),
                   "achieved_adds_per_s": (
                       round(tok_s * l.stage_adds["lcc"])
                       if tok_s is not None and l.stage_adds.get("lcc")
                       else None)}
                  for l in rep.layers],
    }
    stats = getattr(artifact, "pipeline_stats", None) or {}
    waste = stats.get("padding_waste")
    if waste:
        sec["padding_waste"] = waste
    seg = stats.get("segment_layout")
    if seg:
        sec["segment_layout"] = seg
    return sec


def live_roofline(engine) -> dict | None:
    """Roofline table from a *running* compressed engine's own telemetry:
    artifact from the executor, tok/s from ``engine.profiler``, launches
    from the engine's newest decode step.  ``None`` for dense engines, for
    an artifact without a cost report (the seeded fixture's) or when the
    profiler hasn't accumulated any decode steps yet."""
    art = getattr(engine, "artifact", None)
    prof = getattr(engine, "profiler", None)
    if art is None or prof is None or art.report is None:
        return None
    summ = prof.summary()
    if not summ["steps"]:
        return None
    sec = roofline(
        art, summ["tok_s"],
        kernel_launches=engine.kernel_launches_per_step,
        n_layer_plans=engine.n_layer_plans,
        mode="live", arch=getattr(engine.cfg, "name", None))
    sec["profiler"] = summ
    return sec
