"""The port's train step against ``repro.training.trainer.make_train_step``
on the reduced olmo-1b config: the JAX state is converted (params never
re-drawn: ``jax.random`` cannot be reproduced), the same numpy batches go
through the jitted JAX step and the port's step.  Two ProxSGD steps with
site-derived specs (and the same with accumulation; and on the reduced
qwen2.5-3b, QKV biases, and qwen2-vl-7b, an embeddings batch with m-RoPE
ids), two AdamW steps
continued from a JAX state that has already taken one; site specs equal to
the reference's; the meshed step at one rank; the LM launcher on the CPU
and its distributed flags over gloo ranks."""
import json
import os
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
    """Markov-chain tokens; an embeddings-input config (the VLM) takes
    seeded embeddings and m-RoPE ids instead: text positions with a 4 x 4
    patch grid at one temporal position, as Qwen2-VL lays an image out."""
    batch = MarkovLM(vocab=cfg.vocab, k=8, seed=0).batch(b, s, seed=i)
    if cfg.inputs != "embeds":
        return batch
    rng = np.random.default_rng(i)
    pos3 = np.broadcast_to(np.arange(s), (3, b, s)).copy()
    pos3[0, :, 4:20] = 4
    pos3[1, :, 4:20] = 4 + np.repeat(np.arange(4), 4)
    pos3[2, :, 4:20] = 4 + np.tile(np.arange(4), 4)
    return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32),
            "positions3": pos3.astype(np.int32), "labels": batch["labels"]}


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


@pytest.mark.parametrize("arch,accum", [
    ("olmo-1b", 1), ("olmo-1b", 2), ("qwen2.5-3b", 1), ("qwen2-vl-7b", 1)],
    ids=["1", "2", "qwen2.5-3b", "qwen2-vl-7b"])
def test_two_prox_steps_match_the_reference(arch, accum):
    jcfg, tcfg = _cfgs(arch)
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


def test_accumulation_cannot_split_positions3_in_either_package():
    """Both packages split every batch leaf along its leading dimension into
    microbatches (``src/repro/training/trainer.py:116``); ``positions3``
    leads with its three m-RoPE axes, not the batch, so accumulation over
    an m-RoPE batch fails in both."""
    jcfg, tcfg = _cfgs("qwen2-vl-7b")
    b = _batch(tcfg, 0)
    jopt, topt = jo.sgd(0.9), to.sgd(0.9)
    js = jtr.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    ts = train_state_from_numpy(_np_tree(js), tcfg, "cpu")
    with pytest.raises(TypeError, match="reshape"):
        jtr.make_train_step(jcfg, jopt, lr=LR, accum_steps=2)(
            js, {k: jnp.asarray(v) for k, v in b.items()})
    with pytest.raises(RuntimeError, match="shape"):
        ttr.make_train_step(tcfg, topt, lr=LR, accum_steps=2)(
            ts, {k: torch.from_numpy(v) for k, v in b.items()})


def test_step_metrics_stay_on_the_device_and_refusals_name_their_entry(
        tmp_path):
    """The step's metrics are device tensors and it updates in place; a
    meshed step (a one-rank gloo mesh in this process) equals the unsharded
    one bit for bit and takes only a sharded state; compression needs a
    pod axis, as the reference asserts."""
    from types import SimpleNamespace

    from repro_torch.distributed import device_mesh
    from repro_torch.distributed.placement import gather_state, shard_state

    _, tcfg = _cfgs()
    specs = treg.site_group_specs(tapi.abstract_params(tcfg), tcfg, 0.1)
    opt = to.prox_sgd(0.9, specs=specs)
    state = ttr.init_train_state(0, tcfg, opt, prox_specs=specs, device="cpu")
    assert set(state.prox_report) == {s.name for s in specs}
    params = state.params
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 0).items()}
    sharded = None
    device_mesh.join(0, 1, backend="gloo",
                     init_method=f"file://{tmp_path / 'store'}")
    try:
        mesh = device_mesh.make_mesh((1, 1), ("data", "model"))
        sharded = shard_state(state, mesh)
        meshed = ttr.make_train_step(tcfg, opt, lr=LR, prox_specs=specs,
                                     mesh=mesh)
        with pytest.raises(ValueError, match="sharded state"):
            meshed(state, batch)
        sharded, ms = meshed(sharded, batch)
        sharded = gather_state(sharded, mesh)
    finally:
        device_mesh.leave()
    state, m = ttr.make_train_step(tcfg, opt, lr=LR, prox_specs=specs)(
        state, batch)
    assert state.params is params  # updated in place
    assert all(isinstance(v, torch.Tensor) for v in m.values())
    assert int(state.step) == 1 and int(sharded.step) == 1
    assert {k: float(v) for k, v in ms.items()} == {k: float(v) for k, v in m.items()}
    for a, b in to.zip_leaves(state.params, sharded.params):
        assert torch.equal(a, b)
    for mesh in (None, SimpleNamespace(shape={"data": 2, "model": 2})):
        with pytest.raises(ValueError, match="need a pod axis"):
            ttr.make_train_step(tcfg, opt, grad_compression=True, mesh=mesh)


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


@pytest.mark.parametrize("opt", [["--prox"], []], ids=["prox_sgd", "adamw"])
def test_resumed_run_equals_a_straight_run(tmp_path, capsys, opt):
    """4 steps straight == 2 steps, then --resume for 2 more: the final
    checkpoints (params, optimizer state, step, sparsity report) bitwise."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch import train

    base = ["--device", "cpu", "--batch", "2", "--seq", "16", *opt]
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    train.main([*base, "--steps", "4", "--checkpoint-dir", straight])
    first = train.main([*base, "--steps", "2", "--checkpoint-dir", split])
    assert first["steps"] == 2
    # a second writer of step 1 left half-done (no DONE) is not a checkpoint
    os.makedirs(os.path.join(split, "step_0000000001.tmp"))
    rest = train.main([*base, "--steps", "4", "--checkpoint-dir", split,
                       "--resume", "--checkpoint-every", "1"])
    assert "[resume] restored checkpoint step 1" in capsys.readouterr().out
    assert rest["start_step"] == 2 and rest["steps"] == 2
    a = Checkpointer(straight).restore_flat(3)
    b = Checkpointer(split).restore_flat(3)
    assert sorted(a) == sorted(b)
    assert any(k.startswith(".opt_state/") for k in a) and ".step" in a
    for k, v in a.items():
        assert v.dtype == b[k].dtype and v.tobytes() == b[k].tobytes(), k
    assert int(a[".step"]) == 4
    assert Checkpointer(split).all_steps() == [1, 3]


def test_mlp_refuses_checkpoints():
    from repro_torch.launch import train

    for flags in (["--checkpoint-dir", "x"], ["--resume"]):
        with pytest.raises(SystemExit, match="LM path"):
            train.main(["--device", "cpu", "--arch", "mlp", *flags])


LAUNCHER_FLAGS = [
    ("--mesh", ["--mesh", "1x1"]),
    ("--devices", ["--devices", "2", "--mesh", "2x1"]),
    ("--grad-compression", ["--devices", "2", "--mesh", "2x1x1",
                            "--grad-compression"]),
    ("--elastic-demo", ["--devices", "4", "--mesh", "2x2", "--elastic-demo",
                        "--steps", "6"]),
    ("--metrics-out", ["--metrics-out", "m.json"]),
]


@pytest.mark.parametrize("flag,argv", LAUNCHER_FLAGS,
                         ids=[r[0] for r in LAUNCHER_FLAGS])
def test_launcher_refuses_what_is_not_ported(flag, argv, tmp_path,
                                             monkeypatch, capfd):
    """The reference launcher's flags, each run: ``--mesh 1x1`` at one rank
    (bit for bit the unsharded run), ``--devices 2 --mesh 2x1`` over two
    gloo ranks (its checkpoint resumed at one rank), the pod axis with
    ``--grad-compression`` (and the reference's message without it), the
    elastic demo remeshing 4 ranks to 2, and ``--metrics-out`` writing the
    step metrics recorded where the loop prints.  More GPUs than there are
    exit non-zero."""
    from repro_torch.launch import train

    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16"]
    if flag == "--metrics-out":
        train.main(base + argv)
        metrics = json.loads((tmp_path / argv[1]).read_text())["metrics"]
        # the loop prints (and records) at step 0 and at the last step
        assert metrics["train_steps_total"]["values"][0]["value"] == 2
        assert metrics["train_step"]["values"][0]["value"] == 1
        assert {"train_loss", "train_grad_norm", "train_tok_s"} <= set(metrics)
        return
    if flag == "--grad-compression":
        with pytest.raises(SystemExit, match="needs a mesh with a pod axis"):
            train.main(base + ["--grad-compression"])
    if flag == "--devices":
        argv = argv + ["--checkpoint-dir", "ck"]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit, match="only 1 CUDA device"):
            train.main(["--devices", "2", "--mesh", "2x1"])
        monkeypatch.undo()
        monkeypatch.chdir(tmp_path)
    stats = train.main(base + argv)
    out = capfd.readouterr().out
    dims = tuple(int(x) for x in argv[argv.index("--mesh") + 1].split("x"))
    if flag == "--elastic-demo":
        dims = (1, 2)  # the survivors' mesh: data 1 x model min(2, 2)
    assert tuple(stats["mesh"].values()) == dims
    assert np.isfinite(stats["loss"]) and "step    0" in out
    if flag == "--mesh":
        plain = train.main(base)
        assert plain["mesh"] is None and plain["loss"] == stats["loss"]
    if flag == "--devices":
        # written by rank 0 from the gathered state; resumed at one rank
        from repro_torch.checkpoint.checkpointer import Checkpointer

        saved = Checkpointer("ck").restore_flat(1)
        rest = train.main(base[:2] + ["--steps", "3", "--batch", "4", "--seq",
                                      "16", "--mesh", "1x1", "--resume",
                                      "--checkpoint-dir", "ck"])
        assert "[resume] restored checkpoint step 1" in capfd.readouterr().out
        assert rest["start_step"] == 2 and rest["steps"] == 1
        straight = train.main(base[:2] + ["--steps", "2", "--batch", "4",
                                          "--seq", "16", "--checkpoint-dir",
                                          "one"])
        assert abs(straight["loss"] - stats["loss"]) <= 1e-5 * abs(stats["loss"])
        one = Checkpointer("one").restore_flat(1)
        assert sorted(one) == sorted(saved)
        for k, v in one.items():
            np.testing.assert_allclose(saved[k], v, rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(v).max()))
    if flag == "--elastic-demo":
        assert ("[elastic] simulated pod failure; remeshing OrderedDict("
                "{'data': 2, 'model': 2}) -> OrderedDict({'data': 1, "
                "'model': 2}) and resharding state") in out
        assert "step    5" in out and stats["steps"] == 6


def test_launcher_without_a_card_exits_non_zero(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(["--steps", "1"])
