"""Unified telemetry: metrics registry, request tracing, step profiling
(counterpart of ``repro.obs``, with the same names and outputs).

Three pillars, all stdlib-only (no prometheus_client / opentelemetry):

* :mod:`repro_torch.obs.metrics` — a thread-safe :class:`MetricsRegistry` of
  counters, gauges and bounded-bucket histograms, cheap enough for the
  serving host loop, exported as Prometheus text or JSON.  The serving
  engine, scheduler, KV pool, compression pipeline, trainer and the kernel
  dispatch layer all publish into it.
* :mod:`repro_torch.obs.trace` — per-request :class:`Span` lifecycle
  (enqueue -> admit -> prefill -> decode marks -> retire) yielding TTFT,
  time-per-output-token, queue wait and block-growth stalls, dumped as JSONL.
* :mod:`repro_torch.obs.profile` — :class:`StepProfiler` wall-time ring
  buffer with periodic device fencing (``torch.cuda.synchronize``), plus the
  live roofline that ties an artifact's per-site shift-add budget to the
  throughput a *running* engine achieves.

Dependency rule: ``obs`` imports nothing from the rest of ``repro_torch``
(torch only lazily, for fencing), so any layer — including
``kernels.dispatch`` — may publish into it without cycles.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, dump_metrics,
                                     get_global, merged_snapshot,
                                     parse_prometheus, start_metrics_server)
from repro_torch.obs.profile import StepProfiler, live_roofline, roofline
from repro_torch.obs.trace import RequestTracer, Span

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "parse_prometheus",
    "get_global", "merged_snapshot", "dump_metrics", "start_metrics_server",
    "RequestTracer", "Span", "StepProfiler", "roofline", "live_roofline",
]
