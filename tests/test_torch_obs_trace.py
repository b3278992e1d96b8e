"""The port's request tracer (``repro_torch.obs.trace``) against the
reference's: one fake clock drives both tracers through the same call
sequences — a clean request, an errored and a cancelled one, decode marks
at ``mark_every``, annotations, spans left open, a second retire — and the
JSONL files match byte for byte, the ``summary()`` dicts, the spans'
derived times and the registry's request counters and histograms are
equal."""
import json

import pytest

from repro import obs as jobs

from repro_torch import obs as tobs


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> float:
        self.t += dt
        return self.t


def _ok(tr, clk):
    sid = tr.enqueue(0, prompt_len=4)
    clk.tick(1.0)
    tr.admit(sid)
    for _ in range(3):
        clk.tick(1.0)
        tr.token(sid)
    tr.annotate(sid, cached_tokens=2, prefill_kind="paged")
    clk.tick(1.0)
    tr.retire(sid, status="ok")
    assert tr.retire(sid) is None  # one span, one retirement


def _error(tr, clk):
    bad = tr.enqueue(0, prompt_len=0)  # refused at enqueue: never admitted
    tr.retire(bad, status="error", error="empty prompt")
    sid = tr.enqueue(1, prompt_len=3)
    clk.tick(0.25)
    tr.admit(sid)
    clk.tick(0.5)
    tr.token(sid)
    tr.annotate(sid, exhausted=True, blocks_grown=2)
    tr.retire(sid, status="error", error="KV block pool exhausted")


def _cancelled(tr, clk):
    sid = tr.enqueue(7, prompt_len=5)
    clk.tick(0.125)
    tr.admit(sid)
    tr.admit(sid)  # a second admit keeps the first time
    for _ in range(2):
        clk.tick(0.0625)
        tr.token(sid)
    tr.annotate(sid, cancelled=True)
    tr.retire(sid, status="cancelled", error="streaming callback failed")


def _marks(tr, clk):
    for rid in range(3):
        sid = tr.enqueue(rid, prompt_len=8)
        clk.tick(0.001 * (rid + 1))
        tr.admit(sid)
        for _ in range(17 + rid):
            clk.tick(0.02)
            tr.token(sid)
        tr.retire(sid)


def _open(tr, clk):
    _ok(tr, clk)
    sid = tr.enqueue(1, prompt_len=2)  # left open: admitted, one token
    clk.tick(0.5)
    tr.admit(sid)
    tr.token(sid)
    tr.enqueue(2, prompt_len=6)  # left open: never admitted
    tr.token(99)  # unknown span ids are ignored
    tr.annotate(99, x=1)


SEQUENCES = {"ok": _ok, "error": _error, "cancelled": _cancelled,
             "mark_every": _marks, "open": _open}


def _run(obs, name, mark_every, tmp_path):
    clk = FakeClock()
    reg = obs.MetricsRegistry()
    tr = obs.RequestTracer(mark_every=mark_every, metrics=reg, clock=clk)
    SEQUENCES[name](tr, clk)
    out = tmp_path / f"{obs.__name__}.jsonl"
    n_open = tr.dump_jsonl(str(out))
    return tr, reg, n_open, out.read_bytes()


@pytest.mark.parametrize("mark_every", [1, 2, 8])
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_same_calls_give_the_same_spans(name, mark_every, tmp_path):
    jtr, jreg, jopen, jfile = _run(jobs, name, mark_every, tmp_path)
    ttr, treg, topen, tfile = _run(tobs, name, mark_every, tmp_path)
    assert tfile == jfile and topen == jopen
    assert ttr.summary() == jtr.summary()
    assert treg.snapshot() == jreg.snapshot()
    assert ttr.open_count == jtr.open_count
    for status in (None, "ok", "error", "cancelled", "open"):
        assert [s.to_dict() for s in ttr.spans(status)] == \
            [s.to_dict() for s in jtr.spans(status)]
    # completed spans first, then the open ones
    statuses = [json.loads(line)["status"]
                for line in tfile.decode().splitlines()]
    n_done = len(statuses) - topen
    assert "open" not in statuses[:n_done]
    assert statuses[n_done:] == ["open"] * topen


def test_lifecycle_times_and_registry_effects():
    clk = FakeClock()
    reg = tobs.MetricsRegistry()
    tr = tobs.RequestTracer(mark_every=2, metrics=reg, clock=clk)
    _ok(tr, clk)
    (span,) = tr.completed
    assert span.queue_wait_s == 1.0 and span.ttft_s == 2.0
    assert span.tpot_s == 1.0 and span.e2e_s == 5.0
    assert span.n_tokens == 3 and span.marks == [(2, 3.0)]
    assert span.to_dict()["cached_tokens"] == 2
    with pytest.raises(ValueError, match="bogus"):
        tr.retire(tr.enqueue(1, 1), status="bogus")
    assert reg.get("serving_requests_total").get(status="ok") == 1
    for name in ("serving_ttft_seconds", "serving_tpot_seconds",
                 "serving_queue_wait_seconds"):
        assert reg.get(name).values()[0]["count"] == 1
    no_reg = tobs.RequestTracer(clock=clk)  # spans without a registry
    _ok(no_reg, clk)
    assert no_reg.summary()["by_status"] == {"ok": 1}
    assert tobs.RequestTracer(mark_every=0).mark_every == 1
