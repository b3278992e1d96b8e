"""The port's step profiler and roofline (``repro_torch.obs.profile``)
against the reference's: one fake clock gives both profilers the same ring
and ``summary()``; fencing counted every ``fence_every``-th step on host
values (a CPU tensor needs no wait but counts as fenced) and, through a
stand-in CUDA tensor, one ``torch.cuda.synchronize`` a device whose error
raises; ``roofline`` on the quickstart olmo-1b that both packages'
``compress_model`` compress from the same params equals the reference's
dict after the one key rename (``pallas_launches`` -> ``kernel_launches``);
``live_roofline`` is ``None`` for a dense engine, for the seeded fixture
(no cost report), before any step and without metrics, and on a serving
engine carries the reference's keys."""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.serving.engine import ServingEngine as JEngine

from repro_torch import obs as tobs
from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.obs import profile as tprofile
from repro_torch.serving.engine import ServingEngine
from repro_torch.testing import seeded_artifact

QUICKSTART = dict(vocab=64, n_layers=2, d_model=32, d_ff=48, n_heads=2,
                  n_kv_heads=2, head_dim=16)
PROMPTS = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12]]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> float:
        self.t += dt
        return self.t


def _renamed(sec: dict) -> dict:
    return {("kernel_launches" if k == "pallas_launches" else k): v
            for k, v in sec.items()}


def _profile(obs, capacity, fence_every, walls, fence):
    clk = FakeClock()
    prof = obs.StepProfiler(capacity=capacity, fence_every=fence_every,
                            clock=clk)
    for i, dt in enumerate(walls):
        t0 = prof.begin()
        clk.tick(dt)
        assert prof.end(t0, tokens=i % 5, fence=fence) == pytest.approx(dt)
    return prof


@pytest.mark.parametrize("capacity,fence_every", [(4, 0), (4, 2), (64, 3),
                                                  (4096, 32)])
def test_profiler_ring_and_summary_equal_the_reference(capacity, fence_every):
    walls = [0.01 * (1 + (7 * i) % 11) for i in range(40)]
    fence = np.zeros(2, np.float32)
    jp = _profile(jobs, capacity, fence_every, walls, fence)
    tp = _profile(tobs, capacity, fence_every, walls, fence)
    assert tp.summary() == jp.summary()
    assert len(tp) == len(jp) == min(capacity, len(walls))
    assert tp.total_steps == jp.total_steps == len(walls)
    empty = tobs.StepProfiler()
    assert empty.summary() == jobs.StepProfiler().summary()
    assert empty.summary()["tok_s"] is None


FENCES = {"cpu tensor": torch.zeros(3), "list": [torch.zeros(1), 2.0],
          "dict": {"a": (torch.ones(2),), "b": None}, "none": None}


@pytest.mark.parametrize("name", list(FENCES))
def test_fences_are_counted_every_fence_every_th_step(name):
    prof = _profile(tobs, 16, 3, [0.001] * 10, FENCES[name])
    assert prof.summary()["fenced"] == (0 if name == "none" else 3)


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself as lying on ``cuda:<index>``."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", int(self.item()))


def test_a_cuda_fence_synchronizes_each_device_once_and_raises(monkeypatch):
    def cuda(i):
        return torch.Tensor._make_subclass(_CudaLike, torch.tensor(float(i)))

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    prof = tobs.StepProfiler(fence_every=1)
    prof.end(prof.begin(), fence={"x": cuda(0), "y": [cuda(1), cuda(0)]})
    assert sorted(d.index for d in synced) == [0, 1]

    def broken(device):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(torch.cuda, "synchronize", broken)
    with pytest.raises(RuntimeError, match="illegal memory"):
        tprofile._fence(cuda(0))


@pytest.fixture(scope="module")
def quickstart():
    """The reference launcher's quickstart olmo-1b, compressed by both
    packages from the same (converted) params."""
    jcfg = jreduced(jget_arch("olmo-1b"), **QUICKSTART)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = config_from_reference(jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return japi.compress_model(jp, jcfg), tapi.compress_model(tp, tcfg)


@pytest.mark.parametrize("tok_s", [None, 37.5, 1234.5678])
def test_roofline_equals_the_reference(quickstart, tok_s):
    jart, tart = quickstart
    kw = dict(n_layer_plans=1, mode="live", arch="olmo-1b")
    want = _renamed(jobs.roofline(jart, tok_s, pallas_launches=7, **kw))
    got = tobs.roofline(tart, tok_s, kernel_launches=7, **kw)
    assert got == want
    assert got["total_lcc_adds"] == tart.report.total_stage("lcc")
    assert len(got["sites"]) == len(tart.report.layers) > 0


def _fresh(art):
    """``art`` with its own run stats and plan cache: an executor records
    its plans' padding there, which the roofline reports."""
    return replace(art, pipeline_stats=dict(art.pipeline_stats), plans={})


def _serve(engine):
    engine.generate(PROMPTS, max_new_tokens=4)
    return engine


def test_live_roofline_is_none_where_the_reference_has_none(quickstart):
    tart = _fresh(quickstart[1])
    tcfg = tart.config
    dense = _serve(ServingEngine(tart.params, tcfg, n_slots=2, max_len=32,
                                 device="cpu"))
    assert dense.profiler.total_steps > 0 and tobs.live_roofline(dense) is None
    fixture = seeded_artifact(tcfg, seed=1, device="cpu")
    assert fixture.report is None
    seeded = _serve(ServingEngine(artifact=fixture, n_slots=2, max_len=32,
                                  device="cpu"))
    assert tobs.live_roofline(seeded) is None
    fresh = ServingEngine(artifact=tart, n_slots=2, max_len=32, device="cpu")
    assert tobs.live_roofline(fresh) is None  # no decode step yet
    off = _serve(ServingEngine(artifact=tart, n_slots=2, max_len=32,
                               metrics=False, device="cpu"))
    assert tobs.live_roofline(off) is None


def test_live_roofline_of_a_serving_engine(quickstart):
    jart, tart = quickstart
    # the same engines on both sides (dense-effective decode): the same
    # table but for the throughput the two hosts measured
    jeng = _serve(JEngine(artifact=jart, n_slots=2, max_len=32,
                          use_kernel=False))
    teng = _serve(ServingEngine(artifact=tart, n_slots=2, max_len=32,
                                use_kernel=False, device="cpu"))
    want, got = _renamed(jobs.live_roofline(jeng)), tobs.live_roofline(teng)
    timed = ("decode_tok_s_n8", "achieved_adds_per_s", "sites", "profiler")
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in timed} == \
        {k: v for k, v in want.items() if k not in timed}
    assert set(got["profiler"]) == set(want["profiler"])
    assert got["profiler"]["total_steps"] == want["profiler"]["total_steps"]
    strip = ("achieved_adds_per_s",)
    assert [{k: v for k, v in s.items() if k not in strip}
            for s in got["sites"]] == \
        [{k: v for k, v in s.items() if k not in strip} for s in want["sites"]]
    tok_s = got["profiler"]["tok_s"]
    assert got == {**tobs.roofline(tart, tok_s, kernel_launches=0,
                                   n_layer_plans=0, mode="live",
                                   arch=tart.config.name),
                   "profiler": got["profiler"]}
    # through the kernels' route (their plain versions on the CPU): the
    # float32 config takes the whole-step plan
    keng = _serve(ServingEngine(artifact=_fresh(tart), n_slots=2,
                                max_len=32, device="cpu"))
    live = tobs.live_roofline(keng)
    assert live["n_layer_plans"] == 1 and live["kernel_launches"] == 0
    assert live["total_lcc_adds"] == tart.report.total_stage("lcc")
    assert np.isfinite(live["achieved_adds_per_s"]) and \
        live["achieved_adds_per_s"] > 0
