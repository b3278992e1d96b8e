"""Telemetry through the compressor, the trainer and the three launchers,
against the reference's on the CPU: ``run_pipeline(metrics=)`` and
``compress_model(metrics=)`` on the quickstart olmo-1b (the same params)
publish the reference's ``pipeline_events_total{kind}`` and
``pipeline_run{stat}``; ``record_step_metrics`` gives the reference's
gauges for the same dict; each launcher's ``--metrics-out`` file holds the
reference launcher's sections and metric names, with the same values
where neither the host's clock nor the weights (which each package draws
from its own generator, but for the compress launcher, fed the same
params) decide them; ``--trace-out`` one span a request, with the
reference's fields.

Values of the process-wide registry are compared by name only: the
reference's Pallas counter and the port's run-time launch counter live
for the whole worker process."""
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.launch import compress as jcompress_launch
from repro.launch import serve as jserve_launch
from repro.launch import train as jtrain_launch
from repro.models import api as japi
from repro.models import compress_adapters as jca
from repro.pipeline import run_pipeline as jrun
from repro.training.trainer import record_step_metrics as jrecord

from repro_torch import obs as tobs
from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.launch import compress as tcompress_launch
from repro_torch.launch import serve as tserve_launch
from repro_torch.launch import train as ttrain_launch
from repro_torch.models import api as tapi
from repro_torch.models import compress_adapters as tca
from repro_torch.pipeline import run_pipeline as trun
from repro_torch.training.trainer import record_step_metrics as trecord

QUICKSTART = dict(vocab=64, n_layers=2, d_model=32, d_ff=48, n_heads=2,
                  n_kv_heads=2, head_dim=16)
GLOBAL = {"pallas_launches_total", "kernel_launches_total"}
# values the host's clock decides
TIMED = {("pipeline_run", (("stat", "wall_s"),)),
         ("pipeline_run", (("stat", "units_per_s"),)),
         ("train_tok_s", ())}


@pytest.fixture(scope="module")
def quickstart():
    jcfg = jreduced(jget_arch("olmo-1b"), **QUICKSTART)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = config_from_reference(jcfg)
    return (jcfg, jp), (tcfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                                tcfg, "cpu"))


def _values(snap: dict) -> dict:
    """``{(name, labels): value}`` of a snapshot: histograms (times) by
    count, the process-wide launch counters left out."""
    out = {}
    for name, m in snap.items():
        if name in GLOBAL:
            continue
        name = name.replace("pallas", "kernel")
        for row in m["values"]:
            key = (name, tuple(sorted(row["labels"].items())))
            out[key] = row["count"] if m["type"] == "histogram" else row["value"]
    return out


def _names(snap: dict) -> set:
    return {n.replace("pallas", "kernel") for n in snap} - GLOBAL


@pytest.mark.parametrize("entry", ["run_pipeline", "compress_model"])
def test_pipeline_metrics_equal_the_reference(quickstart, entry):
    (jcfg, jp), (tcfg, tp) = quickstart
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    if entry == "run_pipeline":
        jres = jrun(jca.units_from_sites(jp, jca.sites_for(jp, jcfg)),
                    metrics=jreg)
        tres = trun(tca.units_from_sites(tp, tca.sites_for(tp, tcfg)),
                    metrics=treg)
        stats = tres.stats
        assert tres.report.total_stage("lcc") == jres.report.total_stage("lcc")
    else:
        japi.compress_model(jp, jcfg, metrics=jreg)
        stats = tapi.compress_model(tp, tcfg, metrics=treg).pipeline_stats
    want = {k: v for k, v in _values(jreg.snapshot()).items() if k not in TIMED}
    got = {k: v for k, v in _values(treg.snapshot()).items() if k not in TIMED}
    assert got == want
    assert _names(treg.snapshot()) == _names(jreg.snapshot()) == {
        "pipeline_events_total", "pipeline_job_wall_seconds", "pipeline_run"}
    assert got[("pipeline_events_total", (("kind", "unit_done"),))] == \
        stats["units"] == 14


def test_record_step_metrics_gives_the_reference_gauges():
    metrics = {"loss": 1.5, "grad_norm": 2.25, "dead_groups": 3,
               "prox_penalty": 0.125, "shape": (3, 4)}
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    for step, scale in ((7, 1.0), (8, 0.5)):
        jrecord(jreg, {k: (np.float32(v * scale) if isinstance(v, float)
                           else v) for k, v in metrics.items()}, step=step)
        trecord(treg, {k: (torch.tensor(v * scale) if isinstance(v, float)
                           else v) for k, v in metrics.items()}, step=step)
    trecord(treg, {"grid": torch.zeros(2, 2)})  # a non-scalar tensor stays out
    jrecord(jreg, {"grid": np.zeros((2, 2))})
    assert treg.snapshot() == jreg.snapshot()
    assert treg.get("train_steps_total").value == 3
    assert treg.get("train_step").value == 8
    assert "train_shape" not in treg and "train_grid" not in treg
    trecord(None, {"loss": 1.0})  # registry-less: a no-op


def _run_reference(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", ["launcher", *argv])
    main()


def _assert_same_files(jpath, tpath, *, equal_values=True):
    jd, td = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    assert set(td) == set(jd)
    jm, tm = jd["metrics"], td["metrics"]
    assert _names(tm) == _names(jm)
    for name in _names(tm) & _names(jm):
        rname = name.replace("kernel", "pallas") if name not in jm else name
        assert tm[name]["type"] == jm[rname]["type"]
    if equal_values:
        want = {k: v for k, v in _values(jm).items() if k not in TIMED}
        got = {k: v for k, v in _values(tm).items() if k not in TIMED}
        assert got == want
    return jd, td


def test_serve_launcher_files_equal_the_reference(tmp_path, monkeypatch,
                                                  capsys):
    args = ["--reduced", "--requests", "3", "--max-new", "4"]
    j, t = tmp_path / "ref", tmp_path / "port"
    j.mkdir(), t.mkdir()
    _run_reference(monkeypatch, jserve_launch.main,
                   args + ["--metrics-out", str(j / "m.json"),
                           "--trace-out", str(j / "t.jsonl")])
    tserve_launch.main(args + ["--device", "cpu",
                               "--metrics-out", str(t / "m.json"),
                               "--trace-out", str(t / "t.jsonl")])
    out = capsys.readouterr().out
    assert out.count("telemetry summary") == 2
    jd, td = _assert_same_files(j / "m.json", t / "m.json")
    for key in ("completed", "open", "by_status", "tokens"):
        assert td["trace_summary"][key] == jd["trace_summary"][key]
    for key in ("queue_wait_s", "ttft_s", "tpot_s", "e2e_s"):
        assert td["trace_summary"][key]["n"] == jd["trace_summary"][key]["n"]
    assert set(td["profiler"]) == set(jd["profiler"])
    assert td["profiler"]["steps"] == jd["profiler"]["steps"] > 0
    # the reference serves dense weights, the port the seeded fixture: no
    # cost report on either side
    assert td["live_roofline"] is jd["live_roofline"] is None
    jspans = [json.loads(l) for l in (j / "t.jsonl").read_text().splitlines()]
    tspans = [json.loads(l) for l in (t / "t.jsonl").read_text().splitlines()]
    assert len(tspans) == len(jspans) == 3
    assert [set(s) for s in tspans] == [set(s) for s in jspans]
    assert [(s["status"], s["n_tokens"], s["prefill_kind"]) for s in tspans] \
        == [(s["status"], s["n_tokens"], s["prefill_kind"]) for s in jspans] \
        == [("ok", 4, "paged")] * 3


def test_serve_launcher_serves_metrics_on_an_ephemeral_port(capsys):
    tserve_launch.main(["--reduced", "--device", "cpu", "--requests", "2",
                        "--max-new", "2", "--metrics-port", "0"])
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if l.startswith("metrics: "))
    assert line.startswith("metrics: http://127.0.0.1:")
    assert int(line.rsplit(":", 1)[1].split("/")[0]) > 0


def test_compress_launcher_file_equals_the_reference(quickstart, tmp_path,
                                                     monkeypatch):
    """Both launchers on the same params (the port's ``build_model`` handed
    the reference's, converted): the same adds, events and run stats."""
    (tcfg, tp) = quickstart[1]
    monkeypatch.setattr(tcompress_launch, "build_model",
                        lambda arch, quickstart, seed, device: (tp, tcfg))
    args = ["--arch", "olmo-1b", "--quickstart", "--quiet"]
    _run_reference(monkeypatch, jcompress_launch.main,
                   args + ["--out", str(tmp_path / "ref"),
                           "--metrics-out", str(tmp_path / "ref.json")])
    tcompress_launch.main(args + ["--device", "cpu",
                                  "--out", str(tmp_path / "port"),
                                  "--metrics-out", str(tmp_path / "port.json")])
    _, td = _assert_same_files(tmp_path / "ref.json", tmp_path / "port.json")
    adds = {v["labels"]["stage"]: v["value"]
            for v in td["metrics"]["pipeline_adds"]["values"]}
    assert 0 < adds["lcc"] < adds["baseline"]


TRAIN = {"lm": ["--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                "--prox"],
         "mlp": ["--arch", "mlp", "--prox", "--epochs", "1", "--hidden", "32",
                 "--train-n", "256", "--test-n", "64"]}


@pytest.mark.parametrize("path", list(TRAIN))
def test_train_launcher_file_has_the_reference_metrics(path, tmp_path,
                                                       monkeypatch):
    """The same metric names and labels; the same step counts (the weights
    differ: each package draws its own)."""
    args = TRAIN[path]
    _run_reference(monkeypatch, jtrain_launch.main,
                   args + ["--metrics-out", str(tmp_path / "ref.json")])
    ttrain_launch.main(args + ["--device", "cpu",
                               "--metrics-out", str(tmp_path / "port.json")])
    jd, td = _assert_same_files(tmp_path / "ref.json", tmp_path / "port.json",
                                equal_values=False)
    jv, tv = _values(jd["metrics"]), _values(td["metrics"])
    assert set(tv) == set(jv)
    if path == "lm":
        for key in (("train_steps_total", ()), ("train_step", ())):
            assert tv[key] == jv[key]
        assert tv[("train_steps_total", ())] == 2
    else:
        assert set(tv) == {("train_accuracy", (("stage", "dense"),))}
