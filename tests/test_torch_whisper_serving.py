"""Serving the audio family on the port against the JAX package, at the
reduced whisper-small of ``tests/test_torch_whisper.py`` (2 + 2 layers, d
128, ``max_decoder_len`` 32; non-zero q/k/v and fc1/fc2 biases):

* ``api.compress_model`` on the converted parameters: records and packed
  streams bitwise the reference's, encoder sites included; the saved shards
  byte for byte the reference's, each package loading the other's;
* the per-region route (the plain K1/K2/K3) against the same artifact's
  dense-effective decode within 1e-4 with the cross-KV filled, ``routed``
  the reference's rule (``test_whisper_executor_parity``: the ``dec.*``
  sites without ``dec.xattn.k/v``), and against the reference's
  dense-effective decode; the plan refused with ``encoder_decoder``;
* the engine: tokenwise prefill into a contiguous state (no pool), the
  cross-KV kept across ``_reset_slot_state`` while the self-KV resets,
  greedy tokens equal to the reference engine's when both get the same
  cross-KV (dense, and compressed against the reference's dense-effective
  engine), ``{"step": "encoder_decoder"}`` in ``plan_stats()`` and in
  ``serving_plan_fallbacks_total``;
* the two launchers: ``launch/serve.py --arch whisper-small`` serves the
  seeded fixture with the cross-KV at zero, as the reference's launcher
  leaves it; ``launch/compress.py --family audio`` on the reference's
  parameters, fed to both launchers, prints the reference's units and
  jobs, writes its ``stats.json`` values and its artifact shard, and
  ``compressed_adds`` agrees."""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.core.artifact import CompressedModel as JModel
from repro.launch import compress as jlaunch
from repro.models import api as japi
from repro.models import flops as jflops
from repro.serving.engine import ServingEngine as JEngine

from repro_torch.configs import get_arch, reduced_config
from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.core import CompressionConfig
from repro_torch.core.artifact import CompressedModel
from repro_torch.launch import compress as tlaunch
from repro_torch.launch import serve as serve_launch
from repro_torch.models import api as tapi
from repro_torch.models import flops as tflops
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import CompressedExecutor

from test_torch_artifact_io import SHARD, _assert_artifacts_equal
from test_torch_compress import assert_dense_equal
from test_torch_whisper import reference_cross_kv, reference_tree

DECODE_TOL = 1e-4
PROMPTS = [[5, 9, 2, 7], [1, 33, 8], [60, 4, 4, 12, 3]]
S_ENC = 16  # the engines' max_len: the cross-KV's encoder positions
FP = dict(algorithm="fp", max_share_rel_err=0.06)


def _close(got, want, tol=DECODE_TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def routed_by_the_references_rule(sites) -> set:
    return {n for n in sites if n.startswith("dec.") and not (
        n.startswith("dec.xattn.k") or n.startswith("dec.xattn.v"))}


@pytest.fixture(scope="module")
def model():
    jcfg, tree = reference_tree(seed=1)
    tcfg = config_from_reference(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    frames = np.random.default_rng(7).standard_normal(
        (2, S_ENC, tcfg.d_model)).astype(np.float32)
    return jcfg, jp, tcfg, params_from_numpy(tree, tcfg, "cpu"), frames


@pytest.fixture(scope="module")
def arts(model):
    jcfg, jp, tcfg, tp, _ = model
    return (japi.compress_model(jp, jcfg, jcore.CompressionConfig(**FP)),
            tapi.compress_model(tp, tcfg, CompressionConfig(**FP)))


def test_compressed_records_and_shards_are_the_references(arts, tmp_path):
    jart, tart = arts
    assert list(tart.records) == list(jart.records)
    assert any(n.startswith("enc.") for n in tart.records)
    for name, jr in jart.records.items():
        assert_dense_equal(jr, tart.records[name])
        for f in ("idx", "exp", "sign"):
            assert np.array_equal(np.asarray(getattr(jart.packed[name], f)),
                                  getattr(tart.packed[name], f)), (name, f)
    # the run's wall-clock statistics are the only thing taken from the
    # reference's run: no two runs share them
    tart = dataclasses.replace(tart, pipeline_stats=dict(jart.pipeline_stats))
    jart.save(str(tmp_path / "ref"))
    tart.save(str(tmp_path / "port"))
    assert (tmp_path / "port" / SHARD).read_bytes() == \
        (tmp_path / "ref" / SHARD).read_bytes()
    _assert_artifacts_equal(CompressedModel.load(str(tmp_path / "ref"),
                                                 device="cpu"), tart)
    _assert_artifacts_equal(JModel.load(str(tmp_path / "port")), jart)


def _filled_states(model, cfg, b=2):
    """A port and a reference decode state over ``S_ENC`` encoder
    positions, the cross-KV filled by the reference's recipe."""
    jcfg, jp, _, _, frames = model
    ck, cv = reference_cross_kv(jcfg, jp, frames[:b])
    ts = tapi.init_decode_state(cfg, b, S_ENC, device="cpu")
    ts["cross_k"].copy_(torch.from_numpy(np.array(ck)))
    ts["cross_v"].copy_(torch.from_numpy(np.array(cv)))
    js = japi.init_decode_state(jcfg, b, S_ENC)
    js["cross_k"], js["cross_v"] = ck, cv
    return ts, js


def test_per_region_route_against_the_dense_effective_weights(model, arts):
    jart, tart = arts
    cfg = tart.config
    ex = CompressedExecutor(tart, device="cpu")
    assert ex.plan_fallbacks == {"step": "encoder_decoder"}
    assert ex.step_plan(cfg) is None and ex.n_layer_plans == 0
    tok = torch.tensor([[3], [11]])
    jtok = jnp.asarray([[3], [11]], jnp.int32)
    st_k, js = _filled_states(model, cfg)
    st_d, _ = _filled_states(model, cfg)
    for t in range(3):
        pos = torch.tensor([t, t if t < 1 else -1])
        with torch.no_grad():
            l_k, st_k = tapi.decode(tart.params, cfg, st_k, tok, pos, executor=ex)
            l_d, st_d = tapi.decode(tart.params, cfg, st_d, tok, pos)
        l_j, js = japi.decode(jart.params, jart.config, js, jtok,
                              jnp.asarray(pos.numpy(), jnp.int32))
        assert float((l_k - l_d).abs().max()) <= DECODE_TOL
        _close(l_k, l_j)
    assert ex.routed == routed_by_the_references_rule(ex.sites)
    assert ex.sites == set(tart.records) and len(ex.routed) == 8 * cfg.n_layers


def _port_engine(model, **kw):
    """A port engine on the model's parameters (or ``artifact=``), the
    cross-KV of its two slots filled."""
    eng = ServingEngine(n_slots=2, max_len=S_ENC, device="cpu", **kw)
    ts, _ = _filled_states(model, eng.cfg)
    for name in ("cross_k", "cross_v"):
        eng.state[name].copy_(ts[name])
    return eng


def _reference_engine(model, jeng):
    _, js = _filled_states(model, config_from_reference(jeng.cfg))
    jeng.state = dict(jeng.state, cross_k=js["cross_k"], cross_v=js["cross_v"])
    return jeng


def test_engine_prefills_tokenwise_and_keeps_the_cross_kv(model):
    jcfg, jp, tcfg, tp, _ = model
    eng = _port_engine(model, params=tp, cfg=tcfg)
    assert eng.pool is None and not eng.paged
    cross = {n: eng.state[n].clone() for n in ("cross_k", "cross_v")}
    res = eng.generate(PROMPTS, max_new_tokens=4)
    assert [r.stats["prefill_kind"] for r in res] == ["tokenwise"] * 3
    assert 'serving_prefills_total{kind="tokenwise"} 3' in \
        eng.metrics.to_prometheus()
    before = {k: v.clone() for k, v in eng.state.items()}
    eng._reset_slot_state(0)
    for name, v in eng.state.items():
        if name.startswith("cross_"):
            assert torch.equal(v, cross[name]), name  # untouched throughout
        else:
            assert (v[:, 0] == (-1 if "kpos" in name else 0)).all(), name
            assert before[name][:, 0].ne(v[:, 0]).any(), name
            assert torch.equal(v[:, 1], before[name][:, 1]), name
    jeng = _reference_engine(model, JEngine(jp, jcfg, n_slots=2, max_len=S_ENC,
                                            metrics=False))
    want = [r.tokens for r in jeng.generate(PROMPTS, max_new_tokens=4)]
    assert [r.tokens for r in res] == want


def test_compressed_engine_tokens_equal_the_reference(model, arts):
    jart, tart = arts
    jeng = _reference_engine(model, JEngine(artifact=jart, n_slots=2,
                                            max_len=S_ENC, use_kernel=False,
                                            metrics=False))
    want = [r.tokens for r in jeng.generate(PROMPTS, max_new_tokens=6)]
    eng = _port_engine(model, artifact=tart)
    got = [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=6)]
    assert got == want
    ex = eng.executor
    assert ex.routed == routed_by_the_references_rule(tart.records)
    st = eng.plan_stats()
    assert st["n_layer_plans"] == 0 and st["fallbacks"] == {"step": "encoder_decoder"}
    assert 'serving_plan_fallbacks_total{reason="encoder_decoder"} 1' in \
        eng.metrics.to_prometheus()


def test_serve_launcher_serves_the_family(capsys, monkeypatch):
    """The launcher's engine serves with its cross-KV at zero, as the
    reference's launcher leaves it (it has no frames to encode)."""
    engines = []
    run = serve_launch._run
    monkeypatch.setattr(serve_launch, "_run", lambda args, eng, *a: (
        engines.append(eng), run(args, eng, *a)))
    serve_launch.main(["--arch", "whisper-small", "--reduced", "--device", "cpu",
                       "--kernel", "--requests", "2", "--max-new", "3"])
    (eng,) = engines
    assert eng.state["cross_k"].shape[2] == eng.max_len == 128
    assert not eng.state["cross_k"].any() and not eng.state["cross_v"].any()
    assert eng.state["self_kpos"].max() >= 0  # the decoder did run
    out = capsys.readouterr().out
    assert out.count("-> [") == 2 and "[error" not in out
    routed = next(ln for ln in out.splitlines() if ln.startswith("routed "))
    # the decoder's sites without xattn.k/v: 8 of a layer's 16 (the encoder
    # has 6 a layer): 16 of 32 at 2 + 2 layers
    assert routed.startswith("routed 16/32 sites")
    assert "0 layer plan(s); plan fallbacks {'step': 'encoder_decoder'}" in routed


def test_compress_launcher_matches_the_reference_on_the_same_params(
        tmp_path, monkeypatch, capsys):
    """Both launchers (``--arch whisper-small --family audio``, the
    quickstart widths) on the reference's parameters, converted for the
    port: the same ``family= units= jobs=`` line, the same ``stats.json``
    values but the wall times, the artifact shard byte for byte (the port's
    artifact re-saved with the reference's run statistics) and the same
    ``compressed_adds``; the wrong family refused."""
    qs = dict(vocab=64, n_layers=2, d_model=32, d_ff=48, n_heads=2,
              n_kv_heads=2, head_dim=16)
    jcfg = jreduced(jget_arch("whisper-small"), **qs)
    tree = jax.tree.map(np.array, japi.init_params(jax.random.PRNGKey(3), jcfg))
    for blocks in ("enc_blocks", "dec_blocks"):  # non-zero biases
        rng = np.random.default_rng(len(blocks))
        for fc in ("fc1", "fc2"):
            b = tree[blocks]["mlp"][fc]["b"]
            tree[blocks]["mlp"][fc]["b"] = rng.standard_normal(b.shape).astype(
                np.float32)
    tcfg = reduced_config(get_arch("whisper-small"), **qs)
    assert config_from_reference(jcfg) == tcfg
    monkeypatch.setattr(japi, "init_params",
                        lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(tapi, "init_params", lambda seed, cfg, device:
                        params_from_numpy(tree, cfg, device))
    argv = ["--arch", "whisper-small", "--family", "audio", "--quiet"]
    tstats = tlaunch.main([*argv, "--device", "cpu", "--workers", "1",
                           "--out", str(tmp_path / "port")])
    tout = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["compress", *argv, "--quickstart",
                                      "--out", str(tmp_path / "ref")])
    jlaunch.main()
    jout = capsys.readouterr().out

    def family_line(out):
        ln = next(ln for ln in out.splitlines() if ln.startswith("family="))
        return ln.split(" workers=")[0]

    assert family_line(tout) == family_line(jout)
    assert family_line(tout).startswith("family=audio units=32 ")
    timing = ("wall_s", "units_per_s", "total_wall_s")
    ref = json.loads((tmp_path / "ref" / "stats.json").read_text())
    port = json.loads((tmp_path / "port" / "stats.json").read_text())
    assert port == json.loads(json.dumps(tstats))
    assert {k: v for k, v in port.items() if k not in timing} == \
        {k: v for k, v in ref.items() if k not in timing}
    jart = JModel.load(str(tmp_path / "ref" / "artifact"))
    tart = CompressedModel.load(str(tmp_path / "port" / "artifact"), device="cpu")
    dataclasses.replace(tart, pipeline_stats=dict(jart.pipeline_stats)).save(
        str(tmp_path / "resaved"))
    assert (tmp_path / "resaved" / SHARD).read_bytes() == \
        (tmp_path / "ref" / "artifact" / SHARD).read_bytes()
    assert tflops.compressed_adds(tcfg, tart) == \
        jflops.compressed_adds(jart.config, jart)
    with pytest.raises(SystemExit, match="--family dense"):
        tlaunch.main(["--arch", "whisper-small", "--family", "dense",
                      "--device", "cpu", "--out", str(tmp_path / "x")])
