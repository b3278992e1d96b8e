"""Recovery fine-tuning (``repro_torch.training.recover``) against the
reference's ``repro.training.recover`` on the same artifact and batches.

Artifacts are compressed by the reference's ``api.compress_model`` from
``init_mlp_numpy`` parameters (or the quickstart olmo-1b's) and converted,
so both packages start from the same bits (the two compressors are bitwise
the same, ``tests/test_torch_compress_model.py``).

* The training half cannot be bitwise: ``torch.autograd`` and
  ``jax.value_and_grad`` sum the gradients in other orders.  The losses
  agree at every step to ``LOSS_RTOL``.  The deltas agree to
  ``ADAM_ATOL`` under adam: its step ``m / (sqrt(v) + eps)`` is normalised,
  so where a gradient entry is near ``eps`` a float-order difference in it
  moves the step by up to ``lr`` — the bound is loose on purpose (measured
  here: 4.5e-8).  Under sgd, whose step is linear in the gradient, the
  deltas agree to ``SGD_ATOL``.
* ``write_back`` fed the same deltas is bitwise the reference's on every
  surface: records, packed dense slices, params, report rows, summary.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models import compress_adapters as jca
from repro.models import mlp as jmlp
from repro.optim.optimizers import sgd as jsgd
from repro.serving.executor import CompressedExecutor as JExecutor
from repro.training import recover as jrec

from repro_torch.convert import artifact_from_reference
from repro_torch.core.artifact import CompressedModel
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import compress_adapters as tca
from repro_torch.models import mlp as tmlp
from repro_torch.optim.optimizers import sgd as tsgd
from repro_torch.serving.executor import CompressedExecutor
from repro_torch.training import recover as trec

from test_torch_compress import report_rows

IN, HID, CLS = 64, 32, 4
DEAD = [1, 5, 9, 30, 31, 40]  # prox-dead input groups of fc1
LR = 5e-3
LOSS_RTOL = 1e-5
ADAM_ATOL = 1e-5
SGD_ATOL = 1e-6
CONFIGS = {
    # the card's handoff config: dead columns kept in place, no sharing
    "keep_in_place": dict(algorithm="fp", prune_tol=-1e-6,
                          weight_sharing=False, snr_offset_db=-6.0),
    # dead columns compacted, every site weight-shared: the codebook space
    "shared_pruned": dict(algorithm="fp", snr_offset_db=-6.0),
}
QUICKSTART = dict(vocab=64, n_layers=2, d_model=32, d_ff=48, n_heads=2,
                  n_kv_heads=2, head_dim=16)
SHARD = os.path.join("step_0000000000", "shard_0.msgpack")


def _mlp_arts(config):
    """(reference artifact, its conversion) of the MLP under ``config``."""
    npp = tmlp.init_mlp_numpy(0, in_dim=IN, hidden=HID, classes=CLS)
    npp["fc1"]["w"][:, DEAD] = 0.0
    jart = japi.compress_model(jax.tree.map(jnp.asarray, npp),
                               jmlp.MLPConfig(IN, HID, CLS),
                               jcore.CompressionConfig(**CONFIGS[config]))
    return jart, artifact_from_reference(jart, "cpu")


def _batches(n=8, b=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n * b, IN)).astype(np.float32)
    y = rng.integers(0, CLS, n * b).astype(np.int32)
    return [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]) for i in range(n)]


def _jloss(p, b):
    return jmlp.mlp_loss(p, b[0], b[1])


def _tloss(p, b):
    return tmlp.mlp_loss(p, b[0], b[1])


def _run_both(jart, tart, steps, *, use_sgd=False, jloss=_jloss, tloss=_tloss,
              batches=None, to_j=None, to_t=None):
    """``steps`` recovery steps in each package over the same batches;
    returns (reference losses, port losses, reference state, port state)."""
    batches = batches or _batches()
    to_j = to_j or (lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])))
    to_t = to_t or (lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1])))
    js, jstep = jrec.make_recover_step(jart, jloss, lr=LR,
                                       optimizer=jsgd() if use_sgd else None)
    ts, tstep = trec.make_recover_step(tart, tloss, lr=LR,
                                       optimizer=tsgd() if use_sgd else None)
    jl, tl = [], []
    for i in range(steps):
        b = batches[i % len(batches)]
        js, l = jstep(js, to_j(b))
        jl.append(float(l))
        ts, l = tstep(ts, to_t(b))
        tl.append(float(l))
    return np.array(jl), np.array(tl), js, ts


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_recovery_steps_match_the_reference(config, opt):
    jart, tart = _mlp_arts(config)
    assert [s.name for s, _ in trec.recoverable_sites(tart)] == \
        [s.name for s, _ in jrec.recoverable_sites(jart)] == ["fc1", "fc2"]
    if config == "shared_pruned":  # the codebook space is narrower than K
        rec = tart.records["fc1"]
        assert rec.shared is not None and rec.kept_columns.size < IN
    jl, tl, js, ts = _run_both(jart, tart, 24, use_sgd=opt == "sgd")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    assert tl[-1] < tl[0]
    assert ts.step == 24
    for name, jd in js.deltas.items():
        td = ts.deltas[name]
        assert td.dtype == torch.float32 and td.device.type == "cpu"
        assert not td.requires_grad
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=SGD_ATOL if opt == "sgd" else ADAM_ATOL)
        assert np.abs(np.asarray(jd)).max() > 10 * LR  # the residual moved


def _olmo_arts(include=None):
    jcfg = jreduced(jget_arch("olmo-1b"), **QUICKSTART)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    jart = japi.compress_model(jp, jcfg, jcore.CompressionConfig(
        **CONFIGS["keep_in_place"]), include=include)
    return jcfg, jart, artifact_from_reference(jart, "cpu")


def test_recovery_on_stacked_transposed_sites_matches_the_reference():
    """The quickstart olmo-1b: every site an indexed slice of a stacked
    ``[L, K, N]`` leaf, stored transposed; the loss is the model's own."""
    jcfg, jart, tart = _olmo_arts()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (3, 2, 9))
    batches = [(t[:, :-1], t[:, 1:]) for t in toks]
    jl, tl, js, ts = _run_both(
        jart, tart, 3, batches=batches,
        jloss=lambda p, b: japi.train_loss(p, jcfg, {"tokens": b[0],
                                                     "labels": b[1]}),
        tloss=lambda p, b: tapi.train_loss(p, tart.config, {"tokens": b[0],
                                                            "labels": b[1]}),
        to_j=lambda b: (jnp.asarray(b[0], jnp.int32), jnp.asarray(b[1], jnp.int32)),
        to_t=lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1])))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    assert sorted(ts.deltas) == sorted(js.deltas) and len(ts.deltas) == 14
    for name, jd in js.deltas.items():
        np.testing.assert_allclose(ts.deltas[name].numpy(), np.asarray(jd),
                                   rtol=0, atol=ADAM_ATOL, err_msg=name)
        assert np.abs(np.asarray(jd)).max() > 0


def test_rebind_site_traced_is_the_reference_and_carries_the_gradient():
    jcfg, jart, tart = _olmo_arts(include="ffn.down")
    jsite = next(s for s in jrec.recoverable_sites(jart)
                 if s[0].name == "ffn.down.l1")[0]
    tsite = next(s for s in trec.recoverable_sites(tart)
                 if s[0].name == "ffn.down.l1")[0]
    assert tsite.transpose and tsite.index == (1,)
    eff = np.random.default_rng(1).standard_normal(
        tsite.weight(tart.params).shape).astype(np.float32)
    before = tca._lookup(tart.params, tsite.path).clone()
    jnew = tca._lookup(jca.rebind_site_traced(
        jart.params, jsite, jnp.asarray(eff)), jsite.path)
    t_eff = torch.from_numpy(eff).requires_grad_(True)
    tnew = tca._lookup(tca.rebind_site_traced(tart.params, tsite, t_eff),
                       tsite.path)
    assert np.array_equal(tnew.detach().numpy(), np.asarray(jnew))
    (g,) = torch.autograd.grad((tnew * 2.0).sum(), t_eff)
    assert torch.equal(g, torch.full_like(g, 2.0))
    # the original tree is untouched
    old = tca._lookup(tart.params, tsite.path)
    assert not old.requires_grad and torch.equal(old, before)


def _deltas(jart, seed=3):
    """Non-zero residuals for every recoverable unit (codebook space)."""
    rng = np.random.default_rng(seed)
    return {s.name: rng.standard_normal(
                (rec.effective.shape[0], trec._codebook_width(rec))) * 0.05
            for s, rec in jrec.recoverable_sites(jart)}


def _jleaves(t, pre=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _jleaves(v, f"{pre}/{k}")
    else:
        yield pre, t


@pytest.mark.parametrize("config", list(CONFIGS))
def test_write_back_is_bitwise_the_reference(config, tmp_path):
    """The JAX-trained deltas, as tensors, written by both packages: every
    surface bitwise, and (unshared) the saved shards byte for byte."""
    jart, tart = _mlp_arts(config)
    _, _, js, _ = _run_both(jart, tart, 16)
    jsum = jrec.write_back(jart, js.deltas, residual_frac=0.6)
    tsum = trec.write_back(
        tart, {n: torch.tensor(np.asarray(d)) for n, d in js.deltas.items()},
        residual_frac=0.6)
    assert tsum == jsum and any(u["nnz"] > 0 for u in tsum.values())
    for name, jr in jart.records.items():
        tr = tart.records[name]
        assert tr.effective.dtype == np.asarray(jr.effective).dtype
        assert tr.effective.tobytes() == np.asarray(jr.effective).tobytes()
        jp, tp = jart.packed[name], tart.packed[name]
        assert len(tp.dense) == len(jp.dense)
        for (jcs, jw), (tcs, tw) in zip(jp.dense, tp.dense):
            assert tuple(jcs) == tuple(tcs)
            assert tw.dtype == np.float32
            assert np.asarray(jw).tobytes() == np.asarray(tw).tobytes()
    tl = dict((k, v) for k, v in _jleaves(tart.params))
    for k, v in _jleaves(jart.params):
        assert tl[k].numpy().tobytes() == np.asarray(v).tobytes(), k
    assert report_rows(tart.report) == report_rows(jart.report)
    if config == "shared_pruned":
        return  # ``convert`` widens shared labels to int64: other leaf bytes
    jart.save(str(tmp_path / "ref"))
    tart.save(str(tmp_path / "port"))
    assert (tmp_path / "port" / SHARD).read_bytes() == \
        (tmp_path / "ref" / SHARD).read_bytes()


def test_write_back_after_an_upload_serves_the_residual():
    """The device-cache trap: ``on()`` before ``write_back`` must not keep
    serving the old dense slices (``_dev`` used to travel through
    ``dataclasses.replace``)."""
    jart, tart = _mlp_arts("keep_in_place")
    old = tart.packed["fc1"]
    old.on("cpu")
    old.dense_on("cpu")
    assert old._dev
    trec.write_back(tart, {n: torch.from_numpy(d)
                           for n, d in _deltas(jart).items()}, residual_frac=0.6)
    new = tart.packed["fc1"]
    assert new is not old and not new._dev and len(new.dense) == len(old.dense) + 1
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, IN)).astype(np.float32))
    w_eff = tart.params["fc1"]["w"]
    got = tmlp.mlp_forward_compressed(tart.params, new, x)
    h = torch.relu(x @ w_eff.T + tart.params["fc1"]["b"])
    want = h @ tart.params["fc2"]["w"].T + tart.params["fc2"]["b"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    fc1 = tops.apply_packed_decomposition(new, x.T)
    np.testing.assert_allclose(fc1.numpy(), (w_eff @ x.T).numpy(), rtol=0,
                               atol=1e-4)
    # the stale copy would have left the residual out
    stale = tops.apply_packed_decomposition(old, x.T)
    assert float((stale - fc1).abs().max()) > 1e-2


def test_replace_starts_a_fresh_device_cache():
    jart, tart = _mlp_arts("keep_in_place")
    pk = tart.packed["fc1"]
    pk.on("cpu")
    g = tops.pack_group([pk, tart.packed["fc1"]])
    g.on("cpu")
    chain = tops.pack_chain(tart.records["fc2"].decomposition.slices[0])
    chain.on("cpu")
    for obj, change in ((pk, dict(dense=())), (g, dict(members=(pk,))),
                        (chain, dict(n_factors=chain.n_factors))):
        new = dataclasses.replace(obj, **change)
        assert obj._dev and new._dev == {} and new._dev is not obj._dev
    with pytest.raises(TypeError):
        tops.PackedDecomposition(**{**{f.name: getattr(pk, f.name) for f in
                                       dataclasses.fields(pk) if f.init},
                                    "_dev": {}})


def test_write_back_leaves_the_step_plan_stale_as_the_reference():
    """An LM artifact whose step plan was packed before recovery: neither
    package's ``write_back`` touches ``artifact.plans``, so a later
    executor reuses the stale stages (``serving/executor.py``'s plan
    reuse) and the plan route misses the residual that the per-region
    route (``artifact.packed``) and the params serve.  Recorded in ROADMAP
    Queue C; the port follows the reference."""
    jcfg, jart, tart = _olmo_arts()
    assert JExecutor(jart, interpret=True).step_plan(jcfg) is not None
    assert CompressedExecutor(tart, device="cpu").step_plan(tart.config) \
        is not None
    jstages = {n: np.asarray(ps.gidx).copy() for n, ps in jart.plans["step"].items()}
    jplan_obj, tplan_obj = jart.plans["step"], tart.plans["step"]
    deltas = {n: d for n, d in _deltas(jart).items() if n == "ffn.down.l0"}
    jrec.write_back(jart, deltas, residual_frac=0.6)
    trec.write_back(tart, {n: torch.from_numpy(d) for n, d in deltas.items()},
                    residual_frac=0.6)
    # the reference: the same plan object, its stages as they were, reused
    assert jart.plans["step"] is jplan_obj
    for n, ps in jart.plans["step"].items():
        assert np.array_equal(np.asarray(ps.gidx), jstages[n])
    assert JExecutor(jart, interpret=True).step_plan(jcfg).stages is jplan_obj
    # the port: the same, and the served logits show it
    assert tart.plans["step"] is tplan_obj
    cfg = tart.config
    tok = torch.tensor([[3], [41]])
    pos = torch.zeros(2, dtype=torch.long)

    def logits(executor):
        st = tapi.init_decode_state(cfg, 2, 8, device="cpu")
        with torch.no_grad():
            return tapi.decode(tart.params, cfg, st, tok, pos,
                               executor=executor)[0]

    stale = logits(CompressedExecutor(tart, device="cpu"))
    region = logits(CompressedExecutor(tart, use_plans=False, device="cpu"))
    dense = logits(None)
    np.testing.assert_allclose(region.numpy(), dense.numpy(), rtol=0, atol=1e-4)
    assert float((stale - region).abs().max()) > 1e-3
    tart.plans.clear()  # a plan packed after recovery serves the residual
    fresh = logits(CompressedExecutor(tart, device="cpu"))
    np.testing.assert_allclose(fresh.numpy(), region.numpy(), rtol=0, atol=1e-4)


def test_recovered_artifact_round_trips_to_disk(tmp_path):
    """The reference's ``test_train_recover`` flow in the port: recovery
    lowers the loss with the chains frozen, every serving surface agrees
    after ``write_back``, and the recovered values survive save/load."""
    jart, tart = _mlp_arts("keep_in_place")
    chains = {n: r.decomposition.to_dense().tobytes()
              for n, r in tart.records.items()}
    b = _batches(n=1, b=256)[0]
    res = trec.recover_artifact(
        tart, _tloss, [(torch.from_numpy(b[0]), torch.from_numpy(b[1]))] * 40,
        lr=LR, residual_frac=0.6)
    assert len(res["losses"]) == 40 and res["losses"][-1] < res["losses"][0]
    touched = [n for n, u in res["units"].items() if u["nnz"] > 0]
    assert touched
    for n, r in tart.records.items():
        assert r.decomposition.to_dense().tobytes() == chains[n]
    for n in touched:
        row = next(l for l in tart.report.layers if l.name == n)
        assert "recover" in row.stage_adds and row.extra["recovered"] is True
    w_eff = tart.params["fc1"]["w"]
    assert w_eff.numpy().tobytes() == np.asarray(
        tart.records["fc1"].effective, np.float32).tobytes()
    x = torch.from_numpy(b[0])
    fused = tops.apply_packed_decomposition(tart.packed["fc1"], x.T)
    np.testing.assert_allclose(fused.numpy(), (w_eff @ x.T).numpy(), rtol=0,
                               atol=1e-4)
    tart.save(str(tmp_path))
    back = CompressedModel.load(str(tmp_path), device="cpu")
    for k, v in _jleaves(tart.params):
        got = dict(_jleaves(back.params))[k]
        assert got.numpy().tobytes() == v.numpy().tobytes(), k
    assert back.records["fc1"].effective.tobytes() == \
        tart.records["fc1"].effective.tobytes()
    assert len(back.packed["fc1"].dense) == len(tart.packed["fc1"].dense)
    fused = tops.apply_packed_decomposition(back.packed["fc1"], x.T)
    np.testing.assert_allclose(fused.numpy(),
                               (back.params["fc1"]["w"] @ x.T).numpy(),
                               rtol=0, atol=1e-4)
    assert any("recover" in l.stage_adds for l in back.report.layers)
