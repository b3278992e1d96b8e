"""The port's train step against ``repro.training.trainer.make_train_step``
on the reduced olmo-1b config: the JAX state is converted (params never
re-drawn: ``jax.random`` cannot be reproduced), the same numpy batches go
through the jitted JAX step and the port's step.  Two ProxSGD steps with
site-derived specs (and the same with accumulation), two AdamW steps
continued from a JAX state that has already taken one; site specs equal to
the reference's; the LM launcher on the CPU and its refused flags."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models.mlp import MLPConfig as JMLPConfig, init_mlp as jinit_mlp
from repro.optim import optimizers as jo
from repro.training import regularize as jreg
from repro.training import trainer as jtr

from repro_torch.configs import get_arch, reduced_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.synthetic import MarkovLM
from repro_torch.models import api as tapi
from repro_torch.models.mlp import MLPConfig, init_mlp
from repro_torch.optim import optimizers as to
from repro_torch.training import regularize as treg
from repro_torch.training import trainer as ttr

TOL = 1e-5
LR, LAM = 0.05, 15.0  # threshold 0.75: kills part of the ffn.down rows


def _cfgs(arch="olmo-1b"):
    return jreduced(jget_arch(arch), vocab=256), reduced_config(get_arch(arch), vocab=256)


def _batch(cfg, i, b=4, s=32):
    return MarkovLM(vocab=cfg.vocab, k=8, seed=0).batch(b, s, seed=i)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _assert_state_close(ts, js, tol=TOL):
    jp = _np_tree(js.params)
    tp = to.tree_map(lambda x: x.detach().numpy(), ts.params)
    for path, jl in jax.tree_util.tree_leaves_with_path(jp):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        tl = to.tree_get(tp, keys)
        np.testing.assert_allclose(tl, jl, rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(jl).max())),
                                   err_msg="/".join(map(str, keys)))
    assert int(ts.step) == int(js.step)


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b"])
def test_site_group_specs_equal_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    want = jreg.site_group_specs(japi.abstract_params(jcfg), jcfg, 0.1)
    got = treg.site_group_specs(tapi.abstract_params(tcfg), tcfg, 0.1)
    assert [(s.name, s.path, s.lam, s.kind) for s in got] == \
        [(s.name, s.path, s.lam, s.kind) for s in want]
    if arch == "olmo-1b":
        assert len(got) == 7 and {s.kind for s in got} == {"in_rows"}
    for inc in ("ffn", lambda n: n.startswith("attn.q")):
        assert [s.name for s in treg.site_group_specs(
            tapi.abstract_params(tcfg), tcfg, 0.1, include=inc)] == \
            [s.name for s in jreg.site_group_specs(
                japi.abstract_params(jcfg), jcfg, 0.1, include=inc)]
    # abstract parameters allocate nothing and carry the param dtypes
    for leaf in to.tree_leaves(tapi.abstract_params(replace(tcfg, param_dtype="bfloat16"))):
        assert leaf.device.type == "meta"
    mlp = treg.site_group_specs(init_mlp(0, device="cpu"), MLPConfig(), 0.1)
    jm = jreg.site_group_specs(jinit_mlp(jax.random.PRNGKey(0)), JMLPConfig(), 0.1)
    assert [(s.name, s.path, s.kind) for s in mlp] == [(s.name, s.path, s.kind) for s in jm]
    assert [s.kind for s in mlp] == ["in_cols", "in_cols"]


def _pre_prox_margin(jcfg, jstate, specs, batch, thresh, momentum=0.9):
    """Relative distance of every group norm from the threshold right before
    the prox: the same step taken with plain SGD (ProxSGD's state is SGD's)."""
    step = jax.jit(jtr.make_train_step(jcfg, jo.sgd(momentum), lr=LR))
    s, _ = step(jstate, batch)
    norms = np.concatenate([np.asarray(jo.spec_group_norms(
        jo._tree_get(s.params, gs.path), gs.kind)) for gs in specs])
    return float(np.min(np.abs(norms - thresh) / thresh))


@pytest.mark.parametrize("accum", [1, 2])
def test_two_prox_steps_match_the_reference(accum):
    jcfg, tcfg = _cfgs()
    jspecs = jreg.site_group_specs(japi.abstract_params(jcfg), jcfg, LAM)
    tspecs = treg.site_group_specs(tapi.abstract_params(tcfg), tcfg, LAM)
    jopt, topt = jo.prox_sgd(0.9, specs=jspecs), to.prox_sgd(0.9, specs=tspecs)
    js = jtr.init_train_state(jax.random.PRNGKey(0), jcfg, jopt, prox_specs=jspecs)
    ts = train_state_from_numpy(_np_tree(js), tcfg, "cpu")
    jstep = jax.jit(jtr.make_train_step(jcfg, jopt, lr=LR, accum_steps=accum,
                                        prox_specs=jspecs))
    tstep = ttr.make_train_step(tcfg, topt, lr=LR, accum_steps=accum,
                                prox_specs=tspecs)
    dead = []
    for i in range(2):
        b = _batch(tcfg, i)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        # no group within 1e-4 of the threshold: a flip cannot decide this
        assert _pre_prox_margin(jcfg, js, jspecs, jb, LR * LAM) > 1e-4
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "prox_penalty"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL, err_msg=k)
        assert int(tm["dead_groups"]) == int(jm["dead_groups"])
        dead.append(int(tm["dead_groups"]))
        _assert_state_close(ts, js)
        for name, v in ts.prox_report.items():
            assert int(v["dead"]) == int(js.prox_report[name]["dead"])
            np.testing.assert_allclose(float(v["penalty"]),
                                       float(js.prox_report[name]["penalty"]), rtol=TOL)
    assert 0 < dead[0] <= dead[1]
    mu = js.opt_state["mu"]
    for path, jl in jax.tree_util.tree_leaves_with_path(_np_tree(mu)):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        tl = to.tree_get(ts.opt_state["mu"], keys)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL,
                                   atol=TOL * max(1.0, float(np.abs(jl).max())))


def test_adamw_continues_a_reference_state():
    """One JAX AdamW step, the state carried into the port, one more step on
    both sides."""
    jcfg, tcfg = _cfgs()
    jopt, topt = jo.adamw(weight_decay=0.01), to.adamw(weight_decay=0.01)
    js = jtr.init_train_state(jax.random.PRNGKey(1), jcfg, jopt)
    jstep = jax.jit(jtr.make_train_step(jcfg, jopt, lr=3e-3))
    js, _ = jstep(js, {k: jnp.asarray(v) for k, v in _batch(tcfg, 0).items()})
    ts = train_state_from_numpy(_np_tree(js), tcfg, "cpu")
    assert int(ts.opt_state["t"]) == 1 and ts.opt_state["t"].dtype == torch.int32
    b = _batch(tcfg, 1)
    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = ttr.make_train_step(tcfg, topt, lr=3e-3)(
        ts, {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL)
    assert "dead_groups" not in tm
    _assert_state_close(ts, js)
    assert int(ts.opt_state["t"]) == 2


def test_step_metrics_stay_on_the_device_and_refusals_name_their_entry():
    _, tcfg = _cfgs()
    specs = treg.site_group_specs(tapi.abstract_params(tcfg), tcfg, 0.1)
    opt = to.prox_sgd(0.9, specs=specs)
    state = ttr.init_train_state(0, tcfg, opt, prox_specs=specs, device="cpu")
    assert set(state.prox_report) == {s.name for s in specs}
    params = state.params
    state, m = ttr.make_train_step(tcfg, opt, lr=LR, prox_specs=specs)(
        state, {k: torch.from_numpy(v) for k, v in _batch(tcfg, 0).items()})
    assert state.params is params  # updated in place
    assert all(isinstance(v, torch.Tensor) for v in m.values())
    assert int(state.step) == 1
    for kw in ({"grad_compression": True}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="distributed/"):
            ttr.make_train_step(tcfg, opt, **kw)


def test_lm_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import train

    stats = train.main(["--device", "cpu", "--prox", "--steps", "3",
                        "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "[prox] 7 site-derived group specs" in out and "dead 0" in out
    assert stats["steps"] == 3 and np.isfinite(stats["loss"])
    assert stats["group_prox_launches"] == 0  # the plain version on the CPU
    stats = train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                        "--seq", "16", "--accum-steps", "2"])
    assert np.isfinite(stats["loss"])


REFUSED = [("--mesh", "2x2", "distributed/"), ("--devices", "4", "distributed/"),
           ("--grad-compression", None, "distributed/"),
           ("--elastic-demo", None, "distributed/"),
           ("--checkpoint-dir", "ckpt", "slice 6"), ("--resume", None, "slice 6"),
           ("--compress-out", "out", "slice 6"), ("--recover", "5", "slice 6"),
           ("--metrics-out", "m.json", "obs/")]


@pytest.mark.parametrize("flag,value,where", REFUSED, ids=[r[0] for r in REFUSED])
def test_launcher_refuses_what_is_not_ported(flag, value, where):
    from repro_torch.launch import train

    argv = ["--device", "cpu", flag] + ([value] if value is not None else [])
    with pytest.raises(SystemExit, match=where):
        train.main(argv)


def test_launcher_without_a_card_exits_non_zero(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(["--steps", "1"])
