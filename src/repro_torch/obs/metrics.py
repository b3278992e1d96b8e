"""Metrics registry: counters, gauges, bounded-bucket histograms (counterpart
of ``repro.obs.metrics``: the same names, text and JSON).

Design constraints, in order:

1. **Hot-loop cheap.**  The serving engine records 2 counters + 1 histogram
   per fused decode step; a metric update is one dict write under an RLock
   (sub-microsecond), and callers pre-resolve their metric objects once so
   the per-step path never touches the registry's name table.
2. **Thread-safe.**  The scheduler's streaming callbacks, the metrics HTTP
   thread and the pipeline's event stream may all touch the registry
   concurrently; every mutation and every export walks under one registry
   RLock, so exports are consistent snapshots.
3. **Stdlib only.**  Export is Prometheus text (``to_prometheus``) served by
   an ``http.server`` thread (:func:`start_metrics_server`) or a JSON
   snapshot (``snapshot`` / :func:`dump_metrics`); :func:`parse_prometheus`
   closes the round trip for tests and offline tooling.

Labels are declared at metric creation (``labels=("kind",)``) and passed as
keywords on update (``c.inc(1, kind="cache_hit")``).  Histograms use fixed
ascending bucket edges (``le`` semantics: an observation lands in the first
bucket whose edge is >= the value) so memory is bounded regardless of the
observation stream.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_left

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "parse_prometheus", "get_global", "merged_snapshot",
           "dump_metrics", "start_metrics_server", "DEFAULT_TIME_BUCKETS"]

# seconds-scale latency edges: 0.5ms decode steps through 30s prefills
DEFAULT_TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _esc(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unesc(s: str) -> str:
    return (s.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\"))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, label_names, lock):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = lock
        self._vals: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        if not labels and not self.label_names:
            return ()
        if set(labels) != set(self.label_names):
            raise ValueError(f"{self.name}: labels {sorted(labels)} != "
                             f"declared {sorted(self.label_names)}")
        return tuple(str(labels[k]) for k in self.label_names)

    def get(self, **labels) -> float:
        with self._lock:
            return self._vals.get(self._key(labels), 0.0)

    @property
    def value(self) -> float:
        """No-label convenience accessor."""
        return self.get()

    def values(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(zip(self.label_names, k)), "value": v}
                    for k, v in self._vals.items()]


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (n={n})")
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + n


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._vals[k] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)


class Histogram(_Metric):
    """Bounded-bucket histogram: fixed ascending edges + an implicit +Inf
    bucket; per label-set state is ``(bucket counts, sum, count)``."""

    kind = "histogram"

    def __init__(self, name, help, label_names, lock,
                 buckets=DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, label_names, lock)
        edges = tuple(float(b) for b in buckets)
        if not edges or any(nxt <= prev for nxt, prev in zip(edges[1:], edges)):
            raise ValueError(f"{name}: bucket edges must ascend, got {edges}")
        self.buckets = edges

    def observe(self, v: float, **labels) -> None:
        k = self._key(labels)
        i = bisect_left(self.buckets, v)  # le semantics: v == edge lands here
        with self._lock:
            st = self._vals.get(k)
            if st is None:
                st = self._vals[k] = [[0] * (len(self.buckets) + 1), 0.0, 0]
            st[0][i] += 1
            st[1] += v
            st[2] += 1

    def values(self) -> list[dict]:
        with self._lock:
            out = []
            for k, (counts, total, n) in self._vals.items():
                cum, acc = {}, 0
                for edge, c in zip(self.buckets, counts):
                    acc += c
                    cum[_fmt(edge)] = acc
                cum["+Inf"] = acc + counts[-1]
                out.append({"labels": dict(zip(self.label_names, k)),
                            "count": n, "sum": total, "buckets": cum})
            return out


class MetricsRegistry:
    """Name-keyed metric store; ``counter``/``gauge``/``histogram`` are
    get-or-create, so independent subsystems can share one registry without
    coordinating registration order."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_make(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labels, self._lock,
                                              **kw)
                return m
            if not isinstance(m, cls) or m.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} with "
                    f"labels {m.label_names}, requested {cls.kind} with "
                    f"{tuple(labels)}")
            return m

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels,
                                 buckets=buckets)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    # ------------------------------------------------------------------ export
    def snapshot(self) -> dict:
        """JSON-able ``{name: {type, help, values}}`` consistent snapshot."""
        with self._lock:
            return {name: {"type": m.kind, "help": m.help,
                           "values": m.values()}
                    for name, m in sorted(self._metrics.items())}

    def to_prometheus(self) -> str:
        lines: list[str] = []

        def series(name, labels, v):
            if labels:
                lab = ",".join(f'{k}="{_esc(val)}"'
                               for k, val in sorted(labels.items()))
                lines.append(f"{name}{{{lab}}} {_fmt(v)}")
            else:
                lines.append(f"{name} {_fmt(v)}")

        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                for row in m.values():
                    if m.kind == "histogram":
                        for edge, c in row["buckets"].items():
                            series(f"{name}_bucket",
                                   {**row["labels"], "le": edge}, c)
                        series(f"{name}_sum", row["labels"], row["sum"])
                        series(f"{name}_count", row["labels"], row["count"])
                    else:
                        series(name, row["labels"], row["value"])
        return "\n".join(lines) + "\n"

    def flat(self) -> dict:
        """``{(series_name, sorted-label-tuple): value}`` — the exact map
        :func:`parse_prometheus` recovers from ``to_prometheus`` output."""
        out: dict[tuple, float] = {}
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                for row in m.values():
                    if m.kind == "histogram":
                        for edge, c in row["buckets"].items():
                            lab = dict(row["labels"], le=edge)
                            out[(f"{name}_bucket",
                                 tuple(sorted(lab.items())))] = float(c)
                        lab = tuple(sorted(row["labels"].items()))
                        out[(f"{name}_sum", lab)] = float(row["sum"])
                        out[(f"{name}_count", lab)] = float(row["count"])
                    else:
                        out[(name, tuple(sorted(row["labels"].items())))] = \
                            float(row["value"])
        return out


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text back to ``{(name, sorted-label-tuple): value}``.

    Supports exactly what :meth:`MetricsRegistry.to_prometheus` emits (which
    is the standard text exposition format for counters/gauges/histograms).
    """
    out: dict[tuple, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            lab_str, val_str = rest.rsplit("}", 1)
            labels = {}
            # split on '," ' boundaries without breaking escaped quotes
            for part in lab_str.split('",'):
                k, _, v = part.partition('="')
                labels[k.strip()] = _unesc(v.rstrip('"'))
            key = (name, tuple(sorted(labels.items())))
        else:
            name, _, val_str = line.partition(" ")
            key = (name, ())
        v = val_str.strip()
        out[key] = float("inf") if v == "+Inf" else float(v)
    return out


# --------------------------------------------------------------------- global
# Process-wide registry for publishers with no natural owner (the kernel
# dispatch layer's live kernel launch counter).  Engine/pipeline registries
# stay per-instance so tests and concurrent engines don't share counters;
# exports merge both via merged_snapshot / start_metrics_server.
_GLOBAL = MetricsRegistry()


def get_global() -> MetricsRegistry:
    return _GLOBAL


def merged_snapshot(registries) -> dict:
    """Union of several registries' snapshots (later registries win on a
    name collision — pass the most specific one last)."""
    out: dict = {}
    for reg in registries:
        out.update(reg.snapshot())
    return out


def dump_metrics(path: str, registries, **sections) -> None:
    """Write ``{"metrics": merged snapshot, **sections}`` as JSON — the
    on-disk format ``--metrics-out`` produces in every launcher."""
    payload = {"metrics": merged_snapshot(registries)}
    payload.update(sections)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
        f.write("\n")


def start_metrics_server(registries, port: int = 0, host: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (Prometheus text) from a daemon thread.

    Returns the live ``ThreadingHTTPServer`` — read ``.server_port`` when
    ``port=0`` picked an ephemeral one, call ``.shutdown()`` to stop.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    regs = list(registries)

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = "".join(r.to_prometheus() for r in regs).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # keep the serving console clean
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="obs-metrics-http").start()
    return srv
