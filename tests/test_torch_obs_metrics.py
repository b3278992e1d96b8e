"""The port's metrics registry (``repro_torch.obs.metrics``) against the
reference's (``repro.obs.metrics``): the same operations on both give
byte-identical Prometheus text and equal snapshots, flat maps, merged
snapshots and ``dump_metrics`` files; bucket edges with ``le`` semantics,
non-ascending edges and label mismatches refused with the same exception
types; the reference's thread-safety case; the metrics server on
127.0.0.1 with an ephemeral port, scraped with ``urllib``; and the
package's dependency rule (stdlib only at import)."""
import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

from repro import obs as jobs

from repro_torch import obs as tobs

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"reference": jobs, "port": tobs}


def _drive(obs):
    """One registry driven through every kind of update and export edge:
    labels (escaped), a gauge's set/inc/dec, histograms on default and
    custom edges, values on an edge, integral and fractional floats."""
    reg = obs.MetricsRegistry()
    c = reg.counter("requests_total", "by status", labels=("status",))
    c.inc(3, status="ok")
    c.inc(1, status='err "q"\nnew\\line')
    c.inc(0.5, status="ok")
    reg.counter("no_help_total").inc()
    g = reg.gauge("slots", "decode slots")
    g.set(8)
    g.inc(2.5)
    g.dec(1)
    reg.gauge("pool", "pool stats", labels=("stat", "kind")).set(
        1e16, stat="n_blocks", kind="paged")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 1.0, 10.0, 99.0):
        h.observe(v)
    d = reg.histogram("step_seconds", "default edges", labels=("bucket",))
    for v in (0.0004, 0.0005, 0.02, 31.0):
        d.observe(v, bucket="8x1")
    reg.histogram("empty_seconds", "never observed")
    return reg


def test_same_operations_give_the_same_text_and_snapshots():
    ref, port = _drive(jobs), _drive(tobs)
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert port.flat() == ref.flat()
    assert tobs.parse_prometheus(port.to_prometheus()) == \
        jobs.parse_prometheus(ref.to_prometheus()) == port.flat()
    assert tobs.metrics.DEFAULT_TIME_BUCKETS == jobs.metrics.DEFAULT_TIME_BUCKETS
    assert tobs.__all__ == jobs.__all__
    assert tobs.metrics.__all__ == jobs.metrics.__all__


def test_merged_snapshot_and_dump_are_the_reference_files(tmp_path):
    def files(obs, name):
        a, b = _drive(obs), obs.MetricsRegistry()
        b.gauge("slots").set(2)  # later registry wins on a name collision
        b.counter("only_b").inc(4)
        merged = obs.merged_snapshot([a, b])
        out = tmp_path / name
        obs.dump_metrics(str(out), [a, b], trace_summary={"completed": 4},
                         profiler=None, live_roofline={"sites": []})
        return merged, out.read_bytes()

    (jm, jf), (tm, tf) = files(jobs, "ref.json"), files(tobs, "port.json")
    assert tm == jm and tm["slots"]["values"][0]["value"] == 2
    assert tf == jf
    assert set(json.loads(tf)) == {"metrics", "trace_summary", "profiler",
                                   "live_roofline"}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_histogram_bucket_edges_le_semantics(pkg):
    reg = PACKAGES[pkg].MetricsRegistry()
    h = reg.histogram("lat", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 1.0, 10.0, 99.0):
        h.observe(v)
    row = h.values()[0]
    assert row["count"] == 6
    assert row["sum"] == pytest.approx(110.65)
    assert row["buckets"] == {"0.1": 2, "1": 4, "10": 5, "+Inf": 6}


BAD_EDGES = [(1.0, 1.0, 2.0), (2.0, 1.0), ()]
MISUSE = {
    "type": lambda r: (r.counter("req", labels=("kind",)), r.gauge("req")),
    "labels": lambda r: (r.counter("req", labels=("kind",)),
                         r.counter("req", labels=("other",))),
    "undeclared": lambda r: r.counter("req", labels=("kind",)).inc(1, wrong="x"),
    "missing": lambda r: r.counter("req", labels=("kind",)).inc(1),
    "negative": lambda r: r.counter("req").inc(-1),
    **{f"edges{i}": (lambda r, e=e: r.histogram("bad", buckets=e))
       for i, e in enumerate(BAD_EDGES)},
}


@pytest.mark.parametrize("case", list(MISUSE))
def test_misuse_is_refused_with_the_reference_exception(case):
    def raised(obs):
        with pytest.raises(Exception) as e:
            MISUSE[case](obs.MetricsRegistry())
        return type(e.value), str(e.value)

    assert raised(tobs) == raised(jobs)
    assert raised(tobs)[0] is ValueError


def test_get_or_create_and_gauge_arithmetic():
    reg = tobs.MetricsRegistry()
    c1 = reg.counter("req", "requests", labels=("kind",))
    assert reg.counter("req", "requests", labels=("kind",)) is c1
    c1.inc(2, kind="a")
    c1.inc(1, kind="a")
    assert c1.get(kind="a") == 3 and c1.get(kind="b") == 0.0
    assert "req" in reg and reg.get("req") is c1 and reg.get("nope") is None
    g = reg.gauge("temp")
    g.set(5)
    g.dec(2)
    assert g.value == 3
    assert tobs.get_global() is tobs.metrics.get_global()


def test_registry_thread_safety():
    reg = tobs.MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("h", buckets=(0.5, 1.5))
    g = reg.gauge("g")
    errs = []

    def work():
        try:
            for j in range(1000):
                c.inc()
                h.observe(j % 2)
                g.set(j)
                if j % 200 == 0:  # concurrent exports must stay consistent
                    reg.to_prometheus()
                    reg.snapshot()
        except Exception as e:  # pragma: no cover - only on a race
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert c.value == 8000
    row = h.values()[0]
    assert row["count"] == 8000 and row["buckets"]["+Inf"] == 8000


def test_metrics_server_serves_the_registries_on_localhost():
    a, b = _drive(tobs), tobs.MetricsRegistry()
    b.counter("other_total", "a second registry").inc(7)
    srv = tobs.start_metrics_server([a, b], port=0)
    try:
        assert srv.server_address[0] == "127.0.0.1" and srv.server_port > 0
        url = f"http://127.0.0.1:{srv.server_port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        assert text == a.to_prometheus() + b.to_prometheus()
        assert tobs.parse_prometheus(text) == {**a.flat(), **b.flat()}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url.replace("/metrics", "/nope"), timeout=10)
        assert e.value.code == 404
        # the port is taken: a second server on it fails to bind
        with pytest.raises(OSError):
            tobs.start_metrics_server([a], port=srv.server_port)
    finally:
        srv.shutdown()
        srv.server_close()


_PROBE = r"""
import sys
import repro_torch.obs
mods = sorted(m for m in sys.modules if m.split(".")[0] in
              ("repro_torch", "repro", "jax", "torch", "numpy"))
print(mods)
"""


def test_obs_imports_nothing_but_the_standard_library():
    """The reference's dependency rule: ``obs`` imports nothing else of the
    package (torch only lazily, inside the profiler's fence)."""
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT),
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(
        ["repro_torch", "repro_torch.obs", "repro_torch.obs.metrics",
         "repro_torch.obs.profile", "repro_torch.obs.trace"])
